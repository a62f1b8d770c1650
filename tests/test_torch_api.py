"""PyTorch port, the JAX package's public API the earlier slices left out,
each pinned against the JAX function on the same inputs: SE3.compose /
@ / matrix / apply / from_numpy and CameraIntrinsics.matrix / unproject
(core/geometry.py), TSDFVolume.weight / rgb / nbytes (core/state.py),
get_timestamp_ms, LocalClock and StageTimer.summary with its profiler
ranges (utils/timing.py), segmentation.init_params and
train.load_params_npz, config.DEFAULT and integrate_jit's signature."""

import dataclasses
import inspect

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from disinfect_slam_tpu import config as jconfig
from disinfect_slam_tpu.config import TINY_DENSE as J_TINY
from disinfect_slam_tpu.core import geometry as jgeo
from disinfect_slam_tpu.core.state import TSDFVolume as JVolume
from disinfect_slam_tpu.models import segmentation as jseg
from disinfect_slam_tpu.models import train as jtrain
from disinfect_slam_tpu.utils import timing as jtiming
from disinfect_slam_tpu_torch import config
from disinfect_slam_tpu_torch.config import TINY_DENSE
from disinfect_slam_tpu_torch.core import geometry as geo
from disinfect_slam_tpu_torch.io.checkpoint import volume_from_numpy
from disinfect_slam_tpu_torch.models import segmentation as seg
from disinfect_slam_tpu_torch.models import train
from disinfect_slam_tpu_torch.utils import timing

torch.set_num_threads(1)


def _poses(seed, n=6):
    """Random 4x4 float32 rigid transforms (unit quaternions, translations
    within 3 m) as the JAX package builds them from matrices."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = r, rng.uniform(-3, 3, 3)
        out.append(m.astype(np.float32))
    return out


def test_se3_compose_matrix_apply_match_jax():
    pts = np.random.default_rng(1).uniform(-2, 2, (100, 3)).astype(np.float32)
    poses = _poses(0)
    for a, b in zip(poses, poses[1:]):
        ja, jb = jgeo.SE3.from_numpy(a), jgeo.SE3.from_numpy(b)
        pa, pb = geo.SE3.from_numpy(a), geo.SE3.from_numpy(b)
        np.testing.assert_array_equal(pa.q, np.asarray(ja.q))
        for ours, ref in ((pa.compose(pb), ja.compose(jb)), (pa @ pb, ja @ jb)):
            np.testing.assert_allclose(ours.q, np.asarray(ref.q), rtol=0, atol=2e-7)
            np.testing.assert_allclose(ours.t, np.asarray(ref.t), rtol=0, atol=2e-6)
        np.testing.assert_allclose(pa.matrix(), np.asarray(ja.matrix()), rtol=0, atol=2e-7)
        assert pa.matrix().dtype == np.float32 and pa.matrix().shape == (4, 4)
        # the matrix of a composition is the product of the matrices
        np.testing.assert_allclose((pa @ pb).matrix(), pa.matrix() @ pb.matrix(), atol=1e-5)
        np.testing.assert_allclose(pa.apply(torch.from_numpy(pts)).numpy(),
                                   np.asarray(ja.apply(jnp.asarray(pts))), rtol=0, atol=2e-6)
    assert geo.SE3.from_numpy(np.eye(4, dtype=np.float64)).q.dtype == np.float32


def test_intrinsics_matrix_and_unproject_match_jax():
    ji = jgeo.CameraIntrinsics.create(525.1, 525.3, 319.6, 239.7)
    pi = geo.CameraIntrinsics.create(525.1, 525.3, 319.6, 239.7)
    np.testing.assert_array_equal(pi.matrix(), np.asarray(ji.matrix()))
    uv1 = np.random.default_rng(2).uniform(0, 640, (50, 3)).astype(np.float32)
    uv1[:, 2] = 1.0
    np.testing.assert_allclose(pi.inverse().unproject(torch.from_numpy(uv1)).numpy(),
                               np.asarray(ji.inverse().unproject(jnp.asarray(uv1))),
                               rtol=1e-6, atol=1e-7)


def test_volume_views_and_nbytes_match_jax():
    jvol = JVolume.create(J_TINY)
    rng = np.random.default_rng(3)
    rgbw = rng.integers(0, 2 ** 32, jvol.rgbw.shape, dtype=np.uint64).astype(np.uint32)
    rgbw &= np.uint32(0x28FFFFFF)  # weights of at most 40, as fusion keeps them
    jvol = jvol.replace(rgbw=jnp.asarray(rgbw))
    arrays = {f: np.asarray(getattr(jvol, f)) for f in (
        "entry_key", "entry_block", "block_table", "heap", "num_free", "oob_count", "tsdf",
        "rgbw", "prob")}
    pvol = volume_from_numpy(arrays, TINY_DENSE, device="cpu")
    np.testing.assert_array_equal(pvol.weight.numpy(), np.asarray(jvol.weight))
    np.testing.assert_array_equal(pvol.rgb.numpy(), np.asarray(jvol.rgb))
    assert pvol.weight.dtype == pvol.rgb.dtype == torch.uint8
    assert pvol.nbytes() == jvol.nbytes()


def test_timestamps_and_local_clock_match_jax():
    a = jtiming.get_timestamp_ms()
    b = timing.get_timestamp_ms()
    c = jtiming.get_timestamp_ms()
    assert a <= b <= c
    ext = 1_000_000
    ours, ref = timing.LocalClock(ext), jtiming.LocalClock(ext)
    assert abs(ours.offset - ref.offset) <= 5
    assert ours.convert(ext + 250) - ours.offset == ext + 250


def test_stage_timer_summary_and_profiler_ranges():
    t = timing.StageTimer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with t.span("fuse"):
                time.sleep(0.002)
        with t.span("render"):
            pass
    summary = t.summary()
    assert set(summary) == {"fuse", "render"}
    assert summary["fuse"] == t.mean_ms("fuse") >= 2.0
    names = {e.key for e in prof.key_averages()}
    assert {"fuse", "render"} <= names
    ref = jtiming.StageTimer()
    with ref.span("fuse"):
        pass
    assert set(ref.summary()) == {"fuse"}


@pytest.mark.parametrize("arch", ["unet", "fast"])
def test_init_params_names_shapes_and_scale_match_jax(arch):
    jm = jseg.create_model(widths=(8, 16, 32, 32), arch=arch)
    ref = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.jit(lambda r: jseg.init_params(jm, r, 64, 96))(jax.random.PRNGKey(0)),
        sep="/").items()}
    model = seg.create_model(widths=(8, 16, 32, 32), arch=arch)
    ours = seg.init_params(model, torch.Generator().manual_seed(1), 64, 96)
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in ref.items()}
    # both draw kernels with std 1/sqrt(fan_in) (flax's lecun_normal),
    # scales at 1 and biases at 0
    for k, v in ours.items():
        if k.endswith("kernel") and v.size >= 4096:
            fan_in = np.prod(v.shape[:3])
            assert abs(v.std() * np.sqrt(fan_in) - 1) < 0.1, k
            assert abs(ref[k].std() * np.sqrt(fan_in) - 1) < 0.1, k
        elif not k.endswith("kernel"):
            np.testing.assert_array_equal(v, ref[k])
    # the parameters are the model's own
    back = seg.flax_from_state_dict(model.state_dict())
    for k in ours:
        np.testing.assert_array_equal(back[k], ours[k])


def test_train_load_params_npz_matches_jax():
    path = seg.default_weights_path("unet")
    ours = train.load_params_npz(path)
    ref = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jtrain.load_params_npz(path), sep="/").items()}
    assert ours.keys() == ref.keys() and len(ours) == 56
    for k in ref:
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], ref[k])


def test_default_config_is_the_jax_one():
    """config.DEFAULT: the reference's offline example, field for field."""
    assert isinstance(config.DEFAULT, config.TSDFConfig)
    assert dataclasses.asdict(config.DEFAULT) == dataclasses.asdict(jconfig.DEFAULT)


def test_integrate_jit_has_the_jax_signature():
    """ops/integrate.integrate_jit takes the JAX entry's parameters, by name
    and in order (the JAX one's static image size and donated volume are
    the port's key and in-place update)."""
    from disinfect_slam_tpu.ops import integrate as jint
    from disinfect_slam_tpu_torch.ops import integrate as tint

    params = lambda f: list(inspect.signature(f).parameters)  # noqa: E731
    assert params(tint.integrate_jit) == params(jint.integrate_jit) == [
        "vol", "frame", "cam_size", "cam_intr", "max_depth", "cam_T_world_mat"]
