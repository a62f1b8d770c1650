"""PyTorch port, core: config, voxel coordinate helpers, SE3 and camera
math against the JAX package, on the same numpy inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu import config as jconfig
from disinfect_slam_tpu.core import voxel as jvx
from disinfect_slam_tpu.core.geometry import SE3 as JSE3
from disinfect_slam_tpu.core.geometry import CameraIntrinsics as JIntr
from disinfect_slam_tpu.core.geometry import CameraParams as JCam
from disinfect_slam_tpu.ops.integrate import depth_to_range as j_depth_to_range
from disinfect_slam_tpu_torch import config as tconfig
from disinfect_slam_tpu_torch.core import voxel as tvx
from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics, CameraParams
from disinfect_slam_tpu_torch.ops.integrate import depth_to_range

torch.set_num_threads(1)

F32_ULP = float(np.finfo(np.float32).eps)


def test_config_matches_jax_field_for_field():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.TSDFConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.TSDFConfig)]
    assert tf == jf
    assert dataclasses.asdict(tconfig.TINY_DENSE) == dataclasses.asdict(
        jconfig.TINY_DENSE
    )
    for cfg_j in (jconfig.TSDFConfig(), jconfig.TINY_DENSE,
                  jconfig.TSDFConfig(voxel_size=0.004, truncation=0.024)):
        cfg_t = tconfig.TSDFConfig(**dataclasses.asdict(cfg_j))
        for step in (0.001, 0.004, 0.012, 0.03, 0.075, 0.5):
            assert cfg_t.refine_iters(step) == cfg_j.refine_iters(step), step


def test_round_half_away_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-100, 100, 10000),
        np.arange(-20, 20) + 0.5,  # exact halves: roundf, not half-to-even
        [0.0, -0.0, 0.49999997, -0.49999997],
    ]).astype(np.float32)
    ours = tvx.round_half_away(torch.from_numpy(x)).numpy()
    ref = np.asarray(jvx.round_half_away(jnp.asarray(x)))
    np.testing.assert_array_equal(ours, ref)
    assert not np.array_equal(ours, torch.round(torch.from_numpy(x)).numpy())


def test_pack_unpack_and_offsets_match_jax():
    cfg_j = jconfig.TINY_DENSE
    cfg_t = tconfig.TINY_DENSE
    rng = np.random.default_rng(1)
    blocks = rng.integers(cfg_t.coord_min, cfg_t.coord_max + 1, (4096, 3)).astype(np.int32)
    keys = tvx.pack_block_coord(torch.from_numpy(blocks), cfg_t).numpy()
    np.testing.assert_array_equal(
        keys, np.asarray(jvx.pack_block_coord(jnp.asarray(blocks), cfg_j))
    )
    np.testing.assert_array_equal(
        tvx.unpack_block_coord(torch.from_numpy(keys), cfg_t).numpy(), blocks
    )
    assert (keys < tvx.sentinel_key(cfg_t)).all()
    assert tvx.sentinel_key(cfg_t) == jvx.sentinel_key(cfg_j)
    np.testing.assert_array_equal(
        tvx.block_to_point(torch.from_numpy(blocks), cfg_t).numpy(),
        np.asarray(jvx.block_to_point(jnp.asarray(blocks), cfg_j)),
    )
    idx = np.arange(512, dtype=np.int32)
    np.testing.assert_array_equal(
        tvx.index_to_offset(torch.from_numpy(idx), cfg_t).numpy(),
        np.asarray(jvx.index_to_offset(jnp.asarray(idx), cfg_j)),
    )


def test_point_block_offset_maps_match_jax():
    cfg_j, cfg_t = jconfig.TINY_DENSE, tconfig.TINY_DENSE
    pts = np.random.default_rng(6).integers(-300, 300, (4096, 3)).astype(np.int32)
    pts[:3] = [[-1, -8, -9], [7, 8, -16], [0, -7, 15]]  # floor, not truncation
    for name in ("point_to_block", "point_to_offset"):
        ours = getattr(tvx, name)(torch.from_numpy(pts), cfg_t).numpy()
        np.testing.assert_array_equal(ours, np.asarray(getattr(jvx, name)(jnp.asarray(pts), cfg_j)))
    np.testing.assert_array_equal(tvx.point_to_block(torch.from_numpy(pts), cfg_t).numpy(),
                                  pts // 8)
    off = tvx.point_to_offset(torch.from_numpy(pts), cfg_t)
    np.testing.assert_array_equal(
        tvx.offset_to_index(off, cfg_t).numpy(),
        np.asarray(jvx.offset_to_index(jnp.asarray(off.numpy()), cfg_j)))
    np.testing.assert_array_equal(
        tvx.index_to_offset(tvx.offset_to_index(off, cfg_t), cfg_t).numpy(), off.numpy())


def _rotation(kind: str) -> np.ndarray:
    """A rotation hitting one branch of Shepperd's method."""
    if kind == "orbit_frame0":  # trace -1: datasets/orbit_vga frame 0
        return np.diag([-1.0, -1.0, 1.0])
    axis = {"trace": [0.3, -0.5, 0.8], "x": [1, 0.1, 0.05],
            "y": [0.1, 1, -0.05], "z": [0.05, -0.1, 1]}[kind]
    angle = 0.7 if kind == "trace" else 2.9  # large angles: diagonal wins
    a = np.asarray(axis, np.float64)
    a /= np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


@pytest.mark.parametrize("kind", ["trace", "x", "y", "z", "orbit_frame0"])
def test_se3_quaternion_path_matches_jax(kind):
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = _rotation(kind)
    m[:3, 3] = [0.013, -0.021, 0.9]
    ours, ref = SE3.from_matrix(m), JSE3.from_matrix(m)
    # the quaternion, its rotation entries and the inverse quaternion are
    # the same float32 operations: bit-equal (JAX run op by op, as the
    # port runs them)
    np.testing.assert_array_equal(ours.q, np.asarray(ref.q))
    np.testing.assert_array_equal(
        np.float32(ours.rotation_entries()),
        np.asarray(jnp.stack(ref.rotation_entries())),
    )
    np.testing.assert_array_equal(ours.inverse().q, np.asarray(ref.inverse().q))
    # jnp.cross is jit-compiled and XLA:CPU contracts a*b - c*d into an
    # FMA, which the port never does: the inverse translation (two cross
    # products) agrees to 2 ulp of its magnitude
    np.testing.assert_allclose(
        ours.inverse().t, np.asarray(ref.inverse().t), rtol=0,
        atol=2 * F32_ULP * float(np.abs(m[:3, 3]).max() + 1),
    )
    pts = np.random.default_rng(2).uniform(-3, 3, (3, 100)).astype(np.float32)
    got = ours.apply_xyz(*(torch.from_numpy(p) for p in pts))
    want = ref.apply_xyz(*(jnp.asarray(p) for p in pts))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["trace", "x", "orbit_frame0"])
def test_se3_rotate_and_identity_match_jax(kind):
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = _rotation(kind)
    vecs = np.random.default_rng(3).uniform(-1, 1, (500, 3)).astype(np.float32)
    ours = SE3.from_matrix(m).rotate(torch.from_numpy(vecs)).numpy()
    ref = np.asarray(JSE3.from_matrix(m).rotate(jnp.asarray(vecs)))
    # jnp.cross is jit-compiled and XLA:CPU contracts its a*b - c*d into
    # an FMA, which the port never does: a few ulp of the unit scale
    np.testing.assert_allclose(ours, ref, rtol=0, atol=4 * F32_ULP)
    ident = SE3.identity()
    np.testing.assert_array_equal(ident.q, np.asarray(JSE3.identity().q))
    np.testing.assert_array_equal(ident.rotate(torch.from_numpy(vecs)).numpy(), vecs)
    np.testing.assert_array_equal(ident.inverse().t, np.zeros(3, np.float32))


def test_camera_project_matches_jax():
    k = (525.1, 525.3, 319.6, 239.7)
    pts = np.random.default_rng(4).uniform(-2, 2, (300, 3)).astype(np.float32)
    for ours, ref in ((CameraIntrinsics.create(*k), JIntr.create(*k)),
                      (CameraIntrinsics.create(*k).inverse(), JIntr.create(*k).inverse())):
        # the same float32 multiplies and adds, op by op: equal
        np.testing.assert_array_equal(ours.project(torch.from_numpy(pts)).numpy(),
                                      np.asarray(ref.project(jnp.asarray(pts))))


def test_camera_inverse_and_depth_to_range_match_jax():
    k = (525.1, 525.3, 319.6, 239.7)
    ours = CameraParams.create(CameraIntrinsics.create(*k), 48, 64)
    ref = JCam.create(JIntr.create(*k), 48, 64)
    for f in ("fx", "fy", "cx", "cy"):
        assert np.float32(getattr(ours.intrinsics_inv, f)) == np.asarray(
            getattr(ref.intrinsics_inv, f)
        )
    # jnp.linalg.norm is jit-compiled, and XLA:CPU contracts its sum of
    # squares into FMAs, which the port never does: 1 ulp (the root is the
    # correctly rounded float32 one in both)
    np.testing.assert_allclose(
        depth_to_range(ours, "cpu").numpy(), np.asarray(j_depth_to_range(ref)),
        rtol=F32_ULP, atol=0,
    )
