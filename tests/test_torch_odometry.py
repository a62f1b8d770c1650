"""PyTorch port, ICP odometry (systems/odometry.py) against the JAX
package's on the CPU: the vertex and normal maps, the se3 exp map, one
pyramid level of point-to-plane ICP, and ICPOdometry.feed on the scenes
of tests/test_odometry.py.  Inputs come from numpy seeds; each assert
states its tolerance."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from disinfect_slam_tpu.core.geometry import CameraIntrinsics as JIntr
from disinfect_slam_tpu.core.geometry import CameraParams as JCam
from disinfect_slam_tpu.systems import odometry as jodo
from disinfect_slam_tpu_torch.core.geometry import CameraIntrinsics, CameraParams
from disinfect_slam_tpu_torch.systems import odometry as todo

from .scenes import look_at
from .test_odometry import H, K, W, scene_depth

torch.set_num_threads(1)

P0 = look_at((0.0, 0.0, -0.5), (0.0, 0.0, 1.6))
SCENES = {
    "translation": look_at((0.02, 0.01, -0.49), (0.0, 0.0, 1.6)),
    "rotation": look_at((0.0, 0.0, -0.5), (0.05, 0.02, 1.6)),
    "static": P0,
}


def cams(k=K, h=H, w=W):
    return (JCam.create(JIntr.create(*k), h, w),
            CameraParams.create(CameraIntrinsics.create(*k), h, w))


def t(a):
    return torch.from_numpy(np.array(a))


def test_vertex_and_normal_maps_match_jax():
    """Back-projection is exact (the same products in the same order);
    normals within 1e-6 (jnp.linalg.norm and torch's vector_norm round
    their square roots independently)."""
    depth = scene_depth(P0)
    depth[40:50, 60:70] = 0.0  # a hole: zero vertices, zero normals
    jc, tc = cams()
    vj = np.asarray(jodo.vertex_map(jnp.asarray(depth), jc))
    vt = todo.vertex_map(t(depth), tc).numpy()
    np.testing.assert_array_equal(vt, vj)
    nj = np.asarray(jodo.normal_map(jnp.asarray(vj)))
    nt = todo.normal_map(t(vj)).numpy()
    np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-6)


@pytest.mark.parametrize("scale", [1e-7, 1e-3, 0.2, 1.5])
def test_exp_se3_matches_jax(scale):
    """R and t within 1e-6 (sin/cos and the norm of omega round
    independently), from the near-zero branch-free form up to 1.5 rad."""
    xi = np.random.default_rng(int(scale * 1e7)).normal(0, scale, 6).astype(np.float32)
    rj, tj = jodo._exp_se3(jnp.asarray(xi))
    rt, tt = todo._exp_se3(t(xi))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-6)


def test_icp_level_matches_jax():
    """One level of 6 iterations from a seeded perturbation of the true
    pose: world_T_cam within 2e-6, rmse within 1e-5 relative (a float32
    sum of ~10^4 squared residuals, reduced in another order), the same
    inlier count.  The two sum the normal equations in different orders
    (Eigen's gemm against MKL's or OpenBLAS's), the rest is op for op."""
    rng = np.random.default_rng(3)
    p1 = SCENES["translation"]
    ref_depth, cur_depth = scene_depth(P0), scene_depth(p1)
    jc, tc = cams()
    ref_v = np.asarray(jodo.vertex_map(jnp.asarray(ref_depth), jc))
    ref_n = np.asarray(jodo.normal_map(jnp.asarray(ref_v)))
    cur_v = np.asarray(jodo.vertex_map(jnp.asarray(cur_depth), jc))
    ref_pose = P0.astype(np.float32)  # cam_T_world of the reference view
    wtc = np.linalg.inv(P0)
    rw = (ref_v @ wtc[:3, :3].T + wtc[:3, 3]).astype(np.float32)
    nw = (ref_n @ wtc[:3, :3].T).astype(np.float32)
    T0 = np.linalg.inv(p1).astype(np.float32)
    T0[:3, 3] += rng.normal(0, 0.01, 3).astype(np.float32)
    args = dict(iters=6, dist_thresh=0.25, huber_delta=0.05)
    Tj, rj, ij = jodo._icp_level(jnp.asarray(T0), jnp.asarray(cur_v), jnp.asarray(rw),
                                 jnp.asarray(nw), jnp.asarray(ref_depth > 0), jc,
                                 jnp.asarray(ref_pose), **args)
    Tt, rt, it = todo._icp_level(t(T0), t(cur_v), t(rw), t(nw), t(ref_depth > 0), tc,
                                 t(ref_pose), **args)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=2e-6)
    assert float(it) == float(ij) > 5000
    assert abs(float(rt) - float(rj)) <= 1e-5 * float(rj)


def _feed_both(p1, corrupt=False):
    d0, d1 = scene_depth(P0), scene_depth(p1)
    if corrupt:
        d1 = d1.copy()
        d1[40:64, 60:90] = 0.3  # bogus near depth (glare, a dynamic object)
    out = []
    for odo in (jodo.ICPOdometry(K, H, W), todo.ICPOdometry(K, H, W, device="cpu")):
        c0, ok0 = odo.feed(d0)
        c1, ok1 = odo.feed(d1)
        out.append((np.asarray(c0), ok0, np.asarray(c1), ok1))
    return out


@pytest.mark.parametrize("scene", sorted(SCENES) + ["outlier_patch"])
def test_icp_feed_matches_jax(scene):
    """ICPOdometry.feed over two frames (19 iterations over 3 levels):
    the same ok flags, cam_T_world within 1e-5 of the JAX tracker's, and
    the port recovers the motion as tests/test_odometry.py asks of JAX
    (translation within 5 mm, 12 mm with the outlier patch)."""
    p1 = SCENES.get(scene, SCENES["translation"])
    (jc0, jok0, jc1, jok1), (tc0, tok0, tc1, tok1) = _feed_both(
        p1, corrupt=scene == "outlier_patch")
    assert (tok0, tok1) == (jok0, jok1) == (True, True)
    np.testing.assert_allclose(tc0, jc0, rtol=0, atol=0)
    np.testing.assert_allclose(tc1, jc1, rtol=0, atol=1e-5)
    rel_est = tc1 @ np.linalg.inv(tc0)
    rel_true = p1 @ np.linalg.inv(P0)
    t_err = np.linalg.norm(rel_est[:3, 3] - rel_true[:3, 3])
    assert t_err < (0.012 if scene == "outlier_patch" else 0.005), t_err


def test_read_result_is_one_packed_copy():
    """read_result packs pose, rmse and inliers into one copy and counts
    itself."""
    T = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    before = todo.read_result.reads
    Th, rmse, inl = todo.read_result(T, torch.tensor(0.25), torch.tensor(1234.0))
    assert todo.read_result.reads == before + 1
    np.testing.assert_array_equal(Th, T.numpy())
    assert Th.dtype == np.float32 and rmse == np.float32(0.25) and inl == 1234.0
