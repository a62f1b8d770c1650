"""PyTorch port, loop closure (systems/loop_closure.py) against the JAX
package's on the CPU, on the fixtures of tests/test_loop_closure.py: the
Lie helpers (round trips, and against JAX), the place-recognition
descriptor and matcher, the pose-graph relaxation (poses and per-iteration
costs), LoopClosureManager closing the drifted out-and-back chain and
rejecting the aliasing fixture, relocalization, the keyframe cap, map
files crossing both ways (a JAX save loads into the port and a port save
into JAX), and DenseSLAM's keyframe wiring."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.systems import loop_closure as jlc
from disinfect_slam_tpu_torch.config import TSDFConfig
from disinfect_slam_tpu_torch.systems import loop_closure as tlc
from disinfect_slam_tpu_torch.systems.dense_slam import DenseSLAM

from .scenes import checker_rgb, look_at
from .test_loop_closure import CENTER, H, K, W, _out_and_back_keyframes, _texture, scene_depth

torch.set_num_threads(1)

LC_ARGS = dict(kf_every=1, min_gap_frames=50, sim_thresh=0.97, verify_max_rmse=0.05,
               verify_min_inliers=800, max_keyframes=64)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def port_manager(**kw):
    return tlc.LoopClosureManager(K, H, W, **{**LC_ARGS, **kw, "device": "cpu"})


def jax_manager(**kw):
    return jlc.LoopClosureManager(K, H, W, **{**LC_ARGS, **kw})


# ----------------------------------------------------------------------
# Lie helpers
# ----------------------------------------------------------------------
def test_se3_log_exp_roundtrip_and_jax():
    """log(exp(xi)) = xi within 1e-4 (1e-6 near zero), as the JAX test
    asks; exp, log and the rigid inverse within 2e-6 of the JAX helpers'
    (sin, cos, atan2 and sqrt round independently)."""
    rng = np.random.default_rng(0)
    for scale in [0.3] * 20 + [1e-6]:
        xi = (rng.normal(0, scale, 6) if scale > 1e-6 else np.full(6, 1e-6)).astype(np.float32)
        m = tlc._exp_se3_mat(t(xi))
        np.testing.assert_allclose(m.numpy(), np.asarray(jlc._exp_se3_mat(jnp.asarray(xi))),
                                   rtol=0, atol=2e-6)
        back = tlc._se3_log(m).numpy()
        np.testing.assert_allclose(back, xi, atol=1e-4 if scale > 1e-6 else 1e-6)
        np.testing.assert_allclose(back, np.asarray(jlc._se3_log(jnp.asarray(m.numpy()))),
                                   rtol=0, atol=2e-6)
        np.testing.assert_allclose(tlc._inv_rigid(m).numpy(), np.linalg.inv(m.numpy()),
                                   atol=1e-5)
    ms = np.stack([np.asarray(jlc._exp_se3_mat(jnp.asarray(x)))
                   for x in rng.normal(0, 0.5, (3, 6)).astype(np.float32)])
    np.testing.assert_allclose(tlc._inv_rigid(t(ms)).numpy(),
                               np.asarray(jlc._inv_rigid(jnp.asarray(ms))), rtol=0, atol=1e-6)


def test_lie_helpers_have_finite_jacobians_at_identity():
    """The double-where guards: jacfwd through exp and log at xi = 0 (the
    pose graph's linearisation point) is finite and equals JAX's."""
    import jax
    from torch.func import jacfwd

    f_t = lambda x: tlc._se3_log(tlc._exp_se3_mat(x))  # noqa: E731
    f_j = lambda x: jlc._se3_log(jlc._exp_se3_mat(x))  # noqa: E731
    jt = jacfwd(f_t)(torch.zeros(6)).numpy()
    jj = np.asarray(jax.jacfwd(f_j)(jnp.zeros(6, jnp.float32)))
    assert np.isfinite(jt).all() and jt.dtype == np.float32
    np.testing.assert_allclose(jt, jj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(jt, np.eye(6), atol=1e-6)


# ----------------------------------------------------------------------
# descriptor + matcher
# ----------------------------------------------------------------------
@pytest.mark.parametrize("with_intensity", [False, True])
def test_depth_descriptor_matches_jax(with_intensity):
    """Unit norm, and within 1e-6 of the JAX descriptor (cell sums added
    in other orders)."""
    d = scene_depth(look_at((0.6, 0.1, -1.3), CENTER))[::2, ::2]
    inten = _texture(0.3)[::2, ::2] if with_intensity else None
    ours = tlc.depth_descriptor(t(d), None if inten is None else t(inten)).numpy()
    ref = np.asarray(jlc.depth_descriptor(jnp.asarray(d),
                                          None if inten is None else jnp.asarray(inten)))
    assert ours.shape == (tlc.DESC_DIM,)
    assert abs(float(ours @ ours) - 1.0) < 1e-5
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_match_scores_masks_recency_and_count():
    """The JAX test's three cases, each giving JAX's (best, score)."""
    d = scene_depth(look_at((0, 0, -1.5), CENTER))[::2, ::2]
    desc = tlc.depth_descriptor(t(d))
    db = torch.zeros((8, desc.shape[0]))
    db[0] = desc
    db[1] = desc
    ids = torch.full((8,), -(10**9), dtype=torch.int32)
    ids[0], ids[1] = 0, 90
    jd = jnp.asarray(desc.numpy())
    for count, cur, gap, want_best in ((2, 100, 60, 0), (1, 100, 60, 0), (0, 100, 60, None)):
        best, score = tlc._match_scores(desc, db, ids, count, cur, gap)
        jb, js = jlc._match_scores(jd, jnp.asarray(db.numpy()), jnp.asarray(ids.numpy()),
                                   jnp.int32(count), jnp.int32(cur), jnp.int32(gap))
        assert int(best) == int(jb)
        assert abs(float(score) - float(js)) < 1e-6
        if want_best is None:
            assert float(score) < -1.0
        else:
            assert int(best) == want_best and float(score) > 0.999


# ----------------------------------------------------------------------
# pose graph
# ----------------------------------------------------------------------
def _drifted_chain(n=8):
    true = []
    for k in range(n):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [0.1 * k, 0.0, 0.0]
        true.append(m)
    est = []
    for k, m in enumerate(true):
        e = m.copy()
        e[2, 3] += 0.004 * k
        est.append(e)
    ei = list(range(n - 1)) + [0]
    ej = list(range(1, n)) + [n - 1]
    z = [np.linalg.inv(est[k]) @ est[k + 1] for k in range(n - 1)]
    z.append(np.linalg.inv(true[0]) @ true[n - 1])
    w = [1.0] * (n - 1) + [4.0]
    return (true, np.stack(est), np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.stack(z).astype(np.float32), np.asarray(w, np.float32))


def test_pose_graph_matches_jax_and_closes_the_chain():
    """tests/test_loop_closure.py's drifted chain: the relaxed poses within
    2e-5 and every iteration's cost within 1e-4 relative of JAX's (jacfwd
    and the 48x48 solve in float32, summed in other orders), the cost
    falls, node 0 stays put and the endpoint error falls below 35%."""
    true, est, ei, ej, z, w = _drifted_chain()
    opt, costs = tlc.optimize_pose_graph(t(est), torch.from_numpy(ei), torch.from_numpy(ej),
                                         t(z), t(w))
    jopt, jcosts = jlc.optimize_pose_graph(jnp.asarray(est), jnp.asarray(ei), jnp.asarray(ej),
                                           jnp.asarray(z), jnp.asarray(w))
    opt, costs = opt.numpy(), costs.numpy()
    assert costs.shape == (12,) and costs.dtype == np.float32 and opt.dtype == np.float32
    np.testing.assert_allclose(opt, np.asarray(jopt), rtol=0, atol=2e-5)
    np.testing.assert_allclose(costs, np.asarray(jcosts), rtol=1e-4, atol=1e-10)
    assert costs[-1] < costs[0]
    np.testing.assert_allclose(opt[0], est[0], atol=1e-3)
    err_before = np.linalg.norm(est[-1][:3, 3] - true[-1][:3, 3])
    err_after = np.linalg.norm(opt[-1][:3, 3] - true[-1][:3, 3])
    assert err_after < 0.35 * err_before


# ----------------------------------------------------------------------
# the manager
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def out_and_back():
    """Both managers over the 12 keyframes of the drifted out-and-back
    path (frame ids 10 k)."""
    true_poses, est_poses, depths = _out_and_back_keyframes()
    runs = {}
    for name, lc in (("jax", jax_manager()), ("port", port_manager())):
        corr = [(k, c) for k, (d, e) in enumerate(zip(depths, est_poses))
                if (c := lc.add_keyframe(d, e, frame_id=10 * k)) is not None]
        runs[name] = (lc, corr)
    return true_poses, est_poses, runs


def test_loop_closure_reduces_trajectory_error(out_and_back):
    """The port closes the loop where JAX does (the same closures at the
    same keyframes), its optimised keyframe poses within 1e-4 of JAX's,
    and, as the JAX test asks, the error falls below 60% of the drifted
    estimates' and the retro-corrected trajectory end moves toward truth."""
    true_poses, est_poses, runs = out_and_back
    (jl, jcorr), (tl, tcorr) = runs["jax"], runs["port"]
    assert tl.closures == jl.closures >= 1
    assert [k for k, _ in tcorr] == [k for k, _ in jcorr] and tcorr[0][0] >= 5
    assert tl.verifications >= tl.closures
    np.testing.assert_allclose(np.stack(tl.kf_pose_opt), np.stack(jl.kf_pose_opt), rtol=0,
                               atol=1e-4)
    err_est = np.mean([np.linalg.norm(e[:3, 3] - g[:3, 3])
                       for e, g in zip(est_poses, true_poses)])
    err_opt = np.mean([np.linalg.norm(o[:3, 3] - g[:3, 3])
                       for o, g in zip(tl.kf_pose_opt, true_poses)])
    assert err_opt < 0.6 * err_est
    fids = np.arange(0, 120, 5)
    cam_T_world = np.stack([np.linalg.inv(est_poses[min(f // 10, 11)])
                            for f in fids]).astype(np.float32)
    corr = tl.correct_trajectory(fids, cam_T_world)
    np.testing.assert_allclose(corr, jl.correct_trajectory(fids, cam_T_world), rtol=0,
                               atol=1e-4)
    end_before = np.linalg.norm(np.linalg.inv(cam_T_world[-1])[:3, 3] - true_poses[-1][:3, 3])
    end_after = np.linalg.norm(np.linalg.inv(corr[-1])[:3, 3] - true_poses[-1][:3, 3])
    assert end_after < 0.6 * end_before


def test_perceptual_aliasing_rejected():
    """Identical geometry with another texture must not close; the same
    place with the same texture must (the JAX test's fixture)."""
    pose = look_at((0.0, 0.0, -1.5), CENTER)
    depth = scene_depth(pose)
    tex_a, tex_b = _texture(0.0), _texture(1.7)
    dh = t(depth[::2, ::2])
    da = tlc.depth_descriptor(dh, t(tex_a[::2, ::2]))
    db_ = tlc.depth_descriptor(dh, t(tex_b[::2, ::2]))
    assert float(da @ db_) < 0.9
    lc = port_manager()
    wc = np.linalg.inv(pose).astype(np.float32)
    lc.add_keyframe(depth, wc, frame_id=0, intensity=tex_a)
    lc.add_keyframe(depth, wc, frame_id=100, intensity=tex_b)
    assert lc.closures == 0
    c = lc.add_keyframe(depth, wc, frame_id=200, intensity=tex_a)
    assert lc.closures == 1 and c is not None


def test_relocalize_matches_jax():
    """After the outbound leg, a view matching keyframe 3 relocalises
    within 5 mm of its optimised pose and within 1e-4 of JAX's answer; a
    view unlike any keyframe is rejected."""
    from .scenes import render_wall

    _, est_poses, depths = _out_and_back_keyframes()
    out = []
    for lc in (jax_manager(), port_manager()):
        for k in range(6):
            lc.add_keyframe(depths[k], est_poses[k], frame_id=10 * k)
        out.append((lc, lc.relocalize(depths[3])))
    (jl, jt), (tl, tt) = out
    assert tt is not None and jt is not None
    np.testing.assert_allclose(tt[:3, 3], tl.kf_pose_opt[3][:3, 3], atol=0.005)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-4)
    far = look_at((0.0, -2.0, 0.2), (0.0, -2.0, 3.0))
    assert tl.relocalize(render_wall(W, H, K, far, wall_z=40.0)) is None


def test_keyframe_cap_evicts_and_keeps_closing():
    """At max_keyframes=8 the database keeps its cap, node 0 survives,
    the odometry chain stays connected, the device rows follow the host
    lists, and the revisit still closes: the same as JAX's run."""
    _, est_poses, depths = _out_and_back_keyframes()
    runs = []
    for lc in (jax_manager(max_keyframes=8), port_manager(max_keyframes=8)):
        for k in range(len(depths)):
            lc.add_keyframe(depths[k], est_poses[k], frame_id=10 * k)
        runs.append(lc)
    jl, tl = runs
    assert tl.count == jl.count == 8 and tl.evictions == jl.evictions == len(depths) - 8
    assert tl.kf_frame_ids == jl.kf_frame_ids and tl.kf_frame_ids[0] == 0
    assert tl.closures == jl.closures >= 1
    odo = sorted((i, j) for i, j, _z, _w in tl.edges if abs(i - j) == 1)
    assert [i for i, _ in odo] == list(range(tl.count - 1))
    np.testing.assert_array_equal(tl.db_ids[: tl.count].numpy(), np.asarray(tl.kf_frame_ids))
    np.testing.assert_allclose(tl.db_desc.numpy(), np.asarray(jl.db_desc), rtol=0, atol=1e-6)


def test_restated_fixture_equals_the_jax_tests():
    """tests/torch_cases.py's JAX-free copy of the out-and-back fixture
    (the GPU tests and chip_smoke.py use it) gives the JAX test's arrays."""
    from .torch_cases import LC_ARGS as CASE_ARGS
    from .torch_cases import out_and_back_keyframes

    for a, b in zip(out_and_back_keyframes(), _out_and_back_keyframes()):
        np.testing.assert_array_equal(np.stack(a), np.stack(b))
    assert CASE_ARGS == LC_ARGS


def test_kf_every_enforced_inside_manager():
    _, est_poses, depths = _out_and_back_keyframes()
    lc = port_manager(kf_every=10)
    for fid in range(12):
        lc.add_keyframe(depths[fid % len(depths)], est_poses[0], frame_id=fid)
    assert lc.kf_frame_ids == [0, 10]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_map_files_cross_both_ways(tmp_path, direction):
    """A map saved by one package loads into the other with every key:
    the same keyframes, edges and descriptors, and the reloaded map
    relocalises a new session within 5 mm of the saved keyframe 3.  Then
    a new session closes a loop against it (load offsets the new ids)."""
    _, est_poses, depths = _out_and_back_keyframes()
    src, dst = ((jax_manager(sim_thresh=0.99), port_manager(sim_thresh=0.99))
                if direction == "jax_to_port"
                else (port_manager(sim_thresh=0.99), jax_manager(sim_thresh=0.99)))
    for k in range(4):
        src.add_keyframe(depths[k], est_poses[k], frame_id=10 * k)
    path = str(tmp_path / "map.npz")
    src.save(path)
    dst.load(path)
    assert dst.count == src.count and dst.kf_frame_ids == src.kf_frame_ids
    assert len(dst.edges) == len(src.edges)
    assert dst.id_offset == max(src.kf_frame_ids) + LC_ARGS["min_gap_frames"] + 1
    desc = lambda lc: np.asarray(lc.db_desc.numpy() if isinstance(lc.db_desc, torch.Tensor)  # noqa: E731
                                 else lc.db_desc)
    np.testing.assert_allclose(desc(dst), desc(src), atol=1e-6)
    reloc = dst.relocalize(depths[3])
    assert reloc is not None
    np.testing.assert_allclose(reloc[:3, 3], np.asarray(src.kf_pose_opt[3])[:3, 3], atol=0.005)
    c = dst.add_keyframe(depths[1], est_poses[1], frame_id=0)
    assert dst.closures == 1 and c is not None


def test_v1_geometry_only_map_loads_zero_padded(tmp_path):
    """A map from before the appearance channel (384-wide descriptors)
    loads with zero appearance cells, as JAX's load does."""
    _, est_poses, depths = _out_and_back_keyframes()
    src = jax_manager()
    for k in range(3):
        src.add_keyframe(depths[k], est_poses[k], frame_id=10 * k)
    path = str(tmp_path / "v1.npz")
    src.save(path)
    d = dict(np.load(path))
    d["desc"] = d["desc"][:, : tlc._DESC_DIM_V1]
    np.savez(path, **d)
    lc = port_manager()
    lc.load(path)
    ref = jax_manager()
    ref.load(path)
    np.testing.assert_array_equal(lc.db_desc.numpy(), np.asarray(ref.db_desc))
    assert not lc.db_desc[:, tlc._DESC_DIM_V1:].any()


def test_dense_slam_loop_closure_wiring():
    """DenseSLAM(loop_closure=True) stores keyframes at its cadence
    (frames 0, 3, 6) and the correction passthrough is the identity when
    no loop closed (tests/test_loop_closure.py's wiring test)."""
    from .test_dense_slam import SLAM_CFG

    slam = DenseSLAM(K, H, W, voxel_size=0.02, truncation=0.06,
                     cfg=TSDFConfig(**dataclasses.asdict(SLAM_CFG)), loop_closure=True,
                     kf_every=3, lc_kwargs=dict(min_gap_frames=1000, verify_min_inliers=800),
                     device="cpu")
    rgb = checker_rgb(W, H)
    poses = []
    for ang in np.linspace(0, 0.1, 7):
        eye = (np.sin(ang) * 1.8, 0.01 * ang, -1.8 * np.cos(ang) + 0.3)
        p, _ok = slam.process_frame(rgb, scene_depth(look_at(eye, CENTER)))
        poses.append(p.numpy())
    assert slam.lc.count == 3 and slam.lc.kf_frame_ids == [0, 3, 6]
    out = slam.correct_trajectory(np.arange(7), np.stack(poses))
    np.testing.assert_allclose(out, np.stack(poses), atol=1e-5)
