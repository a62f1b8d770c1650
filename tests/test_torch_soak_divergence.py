"""PyTorch port, why its soak parts from the JAX soak's (tests/test_soak.py
at 700 frames): every stage, fed the same state and inputs, agrees with
the JAX package to rounding, and the trajectories part where the
reference itself amplifies an ulp.

scripts/port_soak_fingerprint.py --frames 700 --poses DIR records both
packages' poses: they part at frame 1, by 3.35 mm, stay 6-8 mm apart
(median) over the first 200 frames, meet again where both close the same
loop (frame 200, under 0.1 mm), and part by up to 1.36 m after the turn
(frame 350), ending 0.21 m apart.  The amplifiers, in order:

  - frame 0's fusion: XLA:CPU contracts the jitted projection's
    multiply-adds into fused multiply-adds, so a voxel whose pixel
    coordinate lies within an ulp of a half-pixel tie rounds to the other
    pixel: 62.499996 in the JAX soak, 62.5 in the port.  At a sphere's
    silhouette that pixel holds another surface: 32 voxels part by more
    than 1e-3 (up to 2.0, a voxel fused in one package only).  The JAX
    package's own integrate run eagerly gives the port's volume bit for
    bit.
  - frame 1's model depth, splatted from those volumes, parts at 63
    pixels, and ICP along the corridor's weakly constrained x turns that
    into the 3.35 mm: the JAX tracker fed the port's model depth lands
    within 0.05 mm of the port's pose.
  - the pyramids' normals at pixels whose right and lower neighbours
    are invalid are the normalised rounding residue of cross(-v, -v), so
    an ulp of the vertex turns them anywhere (0.34 mm of frame 1's pose).
  - the pose graph: at keyframe 35 (frame 350) one ulp of its input
    translations moves the JAX graph's output by centimetres.

The saved state (tests/data/soak_700_jax_state.npz, from
scripts/port_soak_fingerprint.py --frames 700 --test-state) is the JAX
soak's keyframe calls, its pose after every 25th frame and its keyframe
map before keyframe calls 20 and 35."""

import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.config import TSDFConfig as JCfg
from disinfect_slam_tpu.core.geometry import SE3 as JSE3
from disinfect_slam_tpu.core.geometry import CameraIntrinsics as JIntr
from disinfect_slam_tpu.core.geometry import CameraParams as JCam
from disinfect_slam_tpu.core.state import TSDFVolume as JVolume
from disinfect_slam_tpu.ops import hash as jhash
from disinfect_slam_tpu.ops.integrate import FrameInput, integrate
from disinfect_slam_tpu.systems import loop_closure as jlc
from disinfect_slam_tpu.systems import odometry as jodo
from disinfect_slam_tpu.systems.dense_slam import DenseSLAM as JSLAM
from disinfect_slam_tpu_torch.config import TSDFConfig as PCfg
from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics
from disinfect_slam_tpu_torch.core.voxel import unpack_block_coord
from disinfect_slam_tpu_torch.io.checkpoint import volume_from_numpy, volume_to_numpy
from disinfect_slam_tpu_torch.ops import hash as phash
from disinfect_slam_tpu_torch.systems import loop_closure as plc
from disinfect_slam_tpu_torch.systems import odometry as podo
from disinfect_slam_tpu_torch.systems.dense_slam import DenseSLAM as PSLAM

from .scenes import checker_rgb
from .torch_cases import SOAK_H, SOAK_K, SOAK_KF_CAP, SOAK_W, soak_corridor_depth, soak_x

torch.set_num_threads(1)

STATE = os.path.join(os.path.dirname(__file__), "data", "soak_700_jax_state.npz")
N_FRAMES = 700
CFG = dict(voxel_size=0.04, truncation=0.12, num_blocks_log2=10, max_candidates=4096,
           max_visible=1024, max_new_per_round=512, backend="dense", grid_log2=5)
LC_KW = dict(kf_every=10, max_keyframes=SOAK_KF_CAP, min_gap_frames=200,
             verify_min_inliers=400)
RGB = checker_rgb(SOAK_W, SOAK_H)
INTENSITY = RGB.astype(np.float32).mean(-1)


def depth_at(i: int) -> np.ndarray:
    return soak_corridor_depth(soak_x(i, N_FRAMES))[0]


def _slams():
    common = dict(voxel_size=0.04, truncation=0.12, max_depth=4.0)
    return (JSLAM(SOAK_K, SOAK_H, SOAK_W, cfg=JCfg(**CFG), **common),
            PSLAM(SOAK_K, SOAK_H, SOAK_W, cfg=PCfg(**CFG), device="cpu", **common))


@pytest.fixture(scope="module")
def frame0():
    """Both DenseSLAMs after the soak's frame 0."""
    js, ps = _slams()
    js.process_frame(RGB, depth_at(0))
    ps.process_frame(RGB, depth_at(0))
    return js, ps


FIELDS = ("entry_key", "entry_block", "block_table", "heap", "num_free", "oob_count", "tsdf",
          "rgbw", "prob")


def _arrays(vol) -> dict:
    if isinstance(vol, JVolume):
        return {f: np.asarray(getattr(vol, f)) for f in FIELDS}
    return volume_to_numpy(vol)


def test_frame0_fusion_parts_only_at_fma_ties(frame0):
    js, ps = frame0
    port = _arrays(ps.volume)
    # the JAX integrate run eagerly (no XLA fusion, so no contraction)
    # gives the port's volume bit for bit
    d0 = depth_at(0)
    frame = FrameInput(rgb=jnp.asarray(RGB, jnp.float32), depth=jnp.asarray(d0),
                       ht=jnp.ones(d0.shape, jnp.float32), lt=jnp.ones(d0.shape, jnp.float32))
    cam = JCam.create(JIntr.create(*SOAK_K), SOAK_H, SOAK_W)
    with jax.disable_jit():
        eager = integrate(JVolume.create(JCfg(**CFG)), frame, cam,
                          JSE3.from_matrix(jnp.eye(4, dtype=jnp.float32)), 4.0)
    for f, a in _arrays(eager).items():
        np.testing.assert_array_equal(port[f], a, err_msg=f)
    # the jitted JAX soak allocates the same blocks; its voxels part by an
    # ulp, and by more (112 voxels, 32 of them by more than 1e-3) only
    # where the pixel coordinate lies within an ulp of a half-pixel tie,
    # which the contracted JAX projection rounds the other way
    jit = _arrays(js.volume)
    for f in ("entry_key", "entry_block", "block_table", "heap", "num_free"):
        np.testing.assert_array_equal(port[f], jit[f], err_msg=f)
    d = np.abs(port["tsdf"] - jit["tsdf"])
    weight_moved = (port["rgbw"] >> 24) != (jit["rgbw"] >> 24)
    rows, cols = np.nonzero((d > 1e-6) | weight_moved)
    assert 0 < len(rows) <= 128, len(rows)
    live = port["entry_block"] >= 0
    pool_to_entry = dict(zip(port["entry_block"][live], np.nonzero(live)[0]))
    key = torch.from_numpy(port["entry_key"][[pool_to_entry[r] for r in rows]])
    u, v = _pixel_coords(unpack_block_coord(key, ps.volume.cfg).numpy().astype(np.int32))
    at = np.arange(len(rows)), cols

    def near_tie(c):
        return np.abs(c - (np.floor(c) + 0.5)) <= 2 * np.spacing(c)

    ties = near_tie(u[at]) | near_tie(v[at])
    assert ties.all(), (u[at][~ties], v[at][~ties])


def _pixel_coords(bp: np.ndarray):
    """The float pixel coordinates, before rounding, of every voxel of the
    blocks bp seen from frame 0's camera: project_rows' ops."""
    intr = CameraIntrinsics.create(*SOAK_K)
    vidx = torch.arange(512, dtype=torch.int32)
    b = torch.from_numpy(bp)
    pts = [((b[:, a:a + 1] << 3) + ((vidx >> (3 * a)) & 7)).float() * 0.04 for a in range(3)]
    xc, yc, z = SE3.identity().apply_xyz(*pts)
    return ((intr.fx * xc + intr.cx * z) / z).numpy(), ((intr.fy * yc + intr.cy * z) / z).numpy()


def _track_jax(js, md, d1, seed, ref):
    pr, pc = js.tracker._prep(jnp.asarray(md)), js.tracker._prep(jnp.asarray(d1))
    return js.tracker._track(jnp.asarray(seed), pc, pr, jnp.asarray(ref))


def _to_torch(pyr):
    return [tuple(torch.from_numpy(np.array(x)) for x in lv) for lv in pyr]


def test_frame1_stages_agree_from_the_same_state(frame0):
    js, ps_own = frame0
    _, ps = _slams()
    ps.volume = volume_from_numpy(_arrays(js.volume), ps.volume.cfg, device="cpu")
    d1 = depth_at(1)
    seed = np.eye(4, dtype=np.float32)
    ref = np.asarray(jnp.linalg.inv(jnp.asarray(seed)))
    np.testing.assert_array_equal(ref, np.linalg.inv(seed))
    # model depth (K4's plain version, then the smoothing): bit-equal
    md = np.asarray(js._model_depth(js.volume, jnp.asarray(ref)))
    np.testing.assert_array_equal(ps._model_depth(SE3.from_matrix(ref)).numpy(), md)
    # pyramids: vertices within an ulp (the contracted back-projection);
    # normals within 1e-5 but at pixels whose right and lower neighbours
    # are invalid, where they are the normalised residue of cross(-v, -v)
    pj = js.tracker._prep(jnp.asarray(md))
    pp = ps.tracker._prep(torch.from_numpy(md))
    cj = js.tracker._prep(jnp.asarray(d1))
    zero_zero = []
    for lv in range(3):
        (vj, nj, okj), (vp, np_, okp) = pj[lv], pp[lv]
        np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
        np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=0, atol=2.4e-7)
        ok = np.asarray(okj)
        lone = ok & ~np.roll(ok, -1, 1) & ~np.roll(ok, -1, 0)
        gap = np.abs(np_.numpy() - np.asarray(nj)).max(-1)
        assert (gap[~lone] <= 1e-5).all(), gap[~lone].max()
        zero_zero.append(int((gap[lone] > 1e-5).sum()))
    assert zero_zero == [2, 0, 0], zero_zero
    # each ICP level from the JAX level's inputs
    ref_wtc = np.asarray(jnp.linalg.inv(jnp.asarray(ref)))
    tj = jnp.asarray(seed)
    for lv in reversed(range(3)):
        vr, nr, okr = pj[lv]
        rw = vr @ ref_wtc[:3, :3].T + ref_wtc[:3, 3]
        nw = nr @ ref_wtc[:3, :3].T
        cam, iters = js.tracker.cams[lv], js.tracker.iters[lv]
        out_j = jax.jit(lambda t, s, a, b, c, r: jodo._icp_level(
            t, s, a, b, c, cam, r, iters, 0.25, 0.05))(tj, cj[lv][0], rw, nw, okr,
                                                       jnp.asarray(ref))
        out_p = podo._icp_level(*(torch.from_numpy(np.array(x)) for x in (
            tj, cj[lv][0], rw, nw, okr)), ps.tracker.cams[lv], torch.from_numpy(ref),
            ps.tracker.iters[lv], 0.25, 0.05)
        np.testing.assert_allclose(out_p[0].numpy(), np.asarray(out_j[0]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(out_p[1]), float(out_j[1]), rtol=1e-5)
        assert float(out_p[2]) == float(out_j[2])
        tj = out_j[0]
    # the whole track: from the JAX pyramids it is the JAX pose; from the
    # port's own, the two 0/0 normals move it by 0.34 mm, and with the JAX
    # normals there it is the JAX pose again
    t_jax = np.asarray(js._track_frame(js.volume, jnp.asarray(ref), jnp.asarray(d1),
                                       jnp.asarray(seed))[0])
    cp = ps.tracker._prep(torch.from_numpy(d1))

    def port_track(pyr_ref):
        return ps.tracker._track(torch.from_numpy(seed), cp, pyr_ref,
                                 torch.from_numpy(ref))[0].numpy()

    np.testing.assert_allclose(port_track(_to_torch(pj)), t_jax, rtol=0, atol=1e-6)
    own = port_track(pp)
    assert 1e-4 < np.abs(own - t_jax).max() < 1e-3
    mixed = list(pp)
    mixed[0] = (pp[0][0], torch.from_numpy(np.array(pj[0][1])), pp[0][2])
    np.testing.assert_allclose(port_track(mixed), t_jax, rtol=0, atol=1e-6)
    # the port's own frame-0 volume: its model depth moves the JAX tracker
    # by the soak's 3.35 mm, onto the port's own frame-1 pose
    md_own = ps_own._model_depth(SE3.from_matrix(ref)).numpy()
    assert 50 <= int((np.abs(md_own - md) > 1e-4).sum()) <= 80
    t_jax_own = np.asarray(_track_jax(js, md_own, d1, seed, ref)[0])
    t_port_own = ps_own.tracker._track(torch.from_numpy(seed), cp,
                                       ps_own.tracker._prep(torch.from_numpy(md_own)),
                                       torch.from_numpy(ref))[0].numpy()
    assert 3e-3 < np.linalg.norm(t_jax_own[:3, 3] - t_jax[:3, 3]) < 4e-3
    assert np.linalg.norm(t_jax_own[:3, 3] - t_port_own[:3, 3]) < 1e-4


def _load_map(lc, st, k: int) -> None:
    """The JAX soak's keyframe map before keyframe call k, on its own
    timeline (load() starts a new session past the loaded ids)."""
    keys = [n[len(f"kf{k}_"):] for n in st.files if n.startswith(f"kf{k}_")]
    buf = io.BytesIO()
    np.savez(buf, **{n: st[f"kf{k}_{n}"] for n in keys})
    buf.seek(0)
    lc.load(buf)
    lc.id_offset = 0
    lc._last_kf_id = lc.kf_frame_ids[-1]


@pytest.fixture(scope="module")
def keyframe_runs():
    """Keyframe calls 20 (frame 200, the first closure) and 35 (frame 350,
    the turn) of the JAX soak, each taken by both packages' managers
    holding the JAX soak's map.  Returns {k: (jax correction, port
    correction, the verification ICPs' results, the pose graph's
    inputs)}."""
    st = np.load(STATE)
    assert int(st["frames"]) == N_FRAMES
    seen, verify, out = {}, {}, {}

    def spy(cls, key):
        orig_v, orig_g = cls._verify, cls._optimize_and_correct

        def v(self, dh, i, seed_pose):
            res = orig_v(self, dh, i, seed_pose)
            verify[key] = (i, None if res is None else np.array(res))
            return res

        def g(self, newest):
            seen[key] = ([np.array(p) for p in self.kf_pose_opt],
                         [(a, b, np.array(z), w) for a, b, z, w in self.edges])
            return orig_g(self, newest)

        cls._verify, cls._optimize_and_correct = v, g
        return cls, orig_v, orig_g

    for k in (20, 35):
        f, pose = int(st["kf_frame"][k]), st["kf_pose"][k]
        j = jlc.LoopClosureManager(SOAK_K, SOAK_H, SOAK_W, **LC_KW)
        p = plc.LoopClosureManager(SOAK_K, SOAK_H, SOAK_W, device="cpu", **LC_KW)
        _load_map(j, st, k)
        _load_map(p, st, k)
        saved = [spy(jlc.LoopClosureManager, "jax"), spy(plc.LoopClosureManager, "port")]
        try:
            depth = depth_at(f)
            cj = j.add_keyframe(depth, pose, f, intensity=INTENSITY)
            cp = p.add_keyframe(depth, pose, f, intensity=INTENSITY)
        finally:
            for cls, orig_v, orig_g in saved:
                cls._verify, cls._optimize_and_correct = orig_v, orig_g
        out[k] = (cj, cp, dict(verify), dict(seen))
    return out


def _graph_arrays(poses, edges):
    n_pad, e_pad = jlc._pad_pow2(len(poses)), jlc._pad_pow2(max(len(edges), 1))
    p = np.stack(poses + [np.eye(4, dtype=np.float32)] * (n_pad - len(poses)))
    ei, ej = np.zeros(e_pad, np.int32), np.zeros(e_pad, np.int32)
    z = np.tile(np.eye(4, dtype=np.float32), (e_pad, 1, 1))
    w = np.zeros(e_pad, np.float32)
    for q, (a, b, zz, ww) in enumerate(edges):
        ei[q], ej[q], z[q], w[q] = a, b, zz, ww
    return p, ei, ej, z, w


@pytest.mark.parametrize("k", [20, 35])
def test_keyframe_stages_agree_from_the_same_state(keyframe_runs, k):
    cj, cp, verify, graph = keyframe_runs[k]
    # the closure decision and the matched keyframe are the same; the
    # verification ICP agrees to rounding
    assert cj is not None and cp is not None
    (ij, tj), (ip, tp) = verify["jax"], verify["port"]
    assert ij == ip
    np.testing.assert_allclose(tp, tj, rtol=0, atol=1e-6)
    # the pose graph gets the same inputs (its loop edge from that ICP)
    (pj, ej), (pp, ep) = graph["jax"], graph["port"]
    for a, b in zip(pj, pp):
        np.testing.assert_array_equal(a, b)
    assert [e[:2] for e in ej] == [e[:2] for e in ep]
    for a, b in zip(ej, ep):
        np.testing.assert_allclose(a[2], b[2], rtol=0, atol=1e-6)
    # and from the JAX inputs it parts from the JAX graph no more than the
    # JAX graph parts from itself when its input translations move by one
    # ulp: at keyframe 20 both gaps are below 1e-5 m, at 35 they are
    # centimetres (the graph's float32 Gauss-Newton wanders on a flat cost)
    p, ei, ejj, z, w = _graph_arrays(pj, ej)
    bumped = p.copy()
    bumped[:, :3, 3] = np.nextafter(p[:, :3, 3], np.float32(np.inf))
    ref, _ = jlc.optimize_pose_graph(*(jnp.asarray(a) for a in (p, ei, ejj, z, w)))
    self_gap = float(np.abs(np.asarray(jlc.optimize_pose_graph(
        *(jnp.asarray(a) for a in (bumped, ei, ejj, z, w)))[0]) - np.asarray(ref)).max())
    ours, _ = plc.optimize_pose_graph(*(torch.from_numpy(a) for a in (p, ei, ejj, z, w)))
    gap = float(np.abs(ours.numpy() - np.asarray(ref)).max())
    assert gap <= max(1e-5, 3 * self_gap), (gap, self_gap)
    assert float(np.abs(cp - cj).max()) <= max(1e-5, 3 * self_gap)
    if k == 35:
        assert self_gap > 1e-3, self_gap


def test_recenter_decisions_agree_on_the_soak_poses():
    """maybe_recenter's decision and new origin every 25 frames, from the
    JAX soak's own poses, through both packages' helpers."""
    st = np.load(STATE)
    jcfg, pcfg = JCfg(**CFG), PCfg(**CFG)
    moves = 0
    for pose in st["recenter_pose"]:
        pos = np.asarray(pose, np.float64)[:3, 3]
        need = jhash.needs_recenter(jcfg, pos, None, 4.0)
        assert phash.needs_recenter(pcfg, pos, None, 4.0) == need
        if need:
            org = jhash.recenter_origin_for(jcfg, pos)
            assert phash.recenter_origin_for(pcfg, pos) == org
            if org != phash.window_origin(pcfg):
                jcfg = dataclasses.replace(jcfg, grid_origin=org)
                pcfg = dataclasses.replace(pcfg, grid_origin=org)
                moves += 1
    assert moves >= 2, moves
