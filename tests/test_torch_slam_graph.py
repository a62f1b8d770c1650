"""PyTorch port, DenseSLAM's tracked frame and the sharded step as
captured steps, on the CPU: the device pose conversion
(core/geometry.pose_floats_of_matrix) against the host's SE3 bit for bit;
the device inverse (core/geometry.inverse4) against numpy's bit for bit
(and the JAX package's within an ulp); TrackFuseStep through utils/graphs'
cache (a stub capturer that replays by running the recorded body again)
against the eager step (capture=False), at track_res_scale 1 and 2 with a
frame of zero depth (tracking lost: the previous pose is kept and fused
with), bit for bit in poses, ok flags and every volume array; the same
sequence against the JAX DenseSLAM (lost_count equal, poses within
tests/test_torch_dense_slam.py's POSE_TOL); the host reads of a tracked
frame (Tensor.cpu, .item, .numpy, .tolist and __bool__ counted: none on a
tracked frame that is not a keyframe, one on a keyframe); ICPOdometry's
captured prep / track and feed against the eager ones; the loop closure's
host-side match against its device match; the sharded step through the
cache against the eager one over ["cpu"] * 4 and ["cpu"], cuts included;
and a capturer that raises making each step raise.  The CUDA graphs
themselves are tested on the card (tests/test_torch_gpu.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.systems.dense_slam import DenseSLAM as JSLAM
from disinfect_slam_tpu_torch.config import TSDFConfig
from disinfect_slam_tpu_torch.core.geometry import (
    SE3, inverse4, pose_floats, pose_floats_of_matrix,
)
from disinfect_slam_tpu_torch.ops.gather import volume_fingerprint
from disinfect_slam_tpu_torch.parallel import sharding as ts
from disinfect_slam_tpu_torch.systems import dense_slam as tds
from disinfect_slam_tpu_torch.systems import odometry
from disinfect_slam_tpu_torch.systems.loop_closure import LoopClosureManager
from disinfect_slam_tpu_torch.utils.graphs import StepGraphs

from .scenes import look_at, render_wall
from .test_dense_slam import CENTER, SLAM_CFG, H, K, W, scene_depth
from .test_integrate import CFG as CFG_HASH
from .test_integrate import CFG_DENSE, MAX_DEPTH, make_frame
from .test_integrate import H as IH
from .test_integrate import K as IK
from .test_integrate import W as IW
from .test_torch_dense_slam import POSE_TOL, RGB
from .test_torch_graph import StubCapture, _random_pose
from .test_torch_hash import jax_arrays, port_arrays

torch.set_num_threads(1)

# an orbit out and back, frame 5 with no depth at all (tracking lost)
ORBIT = [look_at((np.sin(a) * 1.8, 0.01 * a, -1.8 * np.cos(a) + 0.3), CENTER)
         for a in np.linspace(0, 0.14, 6)]
SEQ = ORBIT + ORBIT[::-1][:3]
LOST = 5


def _depths():
    return [np.zeros((H, W), np.float32) if i == LOST else scene_depth(p)
            for i, p in enumerate(SEQ)]


def _slam(capture=True, graphs=None, **kw):
    return tds.DenseSLAM(K, H, W, voxel_size=0.02, truncation=0.06,
                         cfg=TSDFConfig(**dataclasses.asdict(SLAM_CFG)), device="cpu",
                         capture=capture, graphs=graphs, **kw)


def _run(slam, depths):
    poses, oks = [], []
    for d in depths:
        p, ok = slam.process_frame(RGB, d)
        poses.append(np.asarray(p))
        oks.append(bool(ok))
    return np.stack(poses), oks


def _assert_volumes_equal(a, b):
    x, y = port_arrays(a), port_arrays(b)
    for f in x:
        np.testing.assert_array_equal(x[f], y[f], err_msg=f)
    assert volume_fingerprint(x) == volume_fingerprint(y)


# ----------------------------------------------------------------------
# the device pose and the device inverse
# ----------------------------------------------------------------------
def _rotations(rng, n):
    """Random poses, and poses whose rotation takes each branch of the
    quaternion (the trace at or below 0, ties on the diagonal)."""
    out = [_random_pose(rng) for _ in range(n)]
    for diag in ((1, -1, -1), (-1, 1, -1), (-1, -1, 1), (-1, -1, -1), (0.5, 0.5, -1.0)):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.diag(diag)
        m[:3, 3] = rng.normal(size=3)
        out.append(m)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_pose_floats_of_matrix_equals_the_host_pose(seed):
    """The 32 slots computed from a matrix tensor hold the bits the host's
    SE3.from_matrix and pose_floats give, on every quaternion branch."""
    rng = np.random.default_rng(seed)
    for m in _rotations(rng, 400):
        dev = pose_floats_of_matrix(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(dev.view(np.uint32),
                                      pose_floats(SE3.from_matrix(m)).view(np.uint32))


@pytest.mark.parametrize("seed", range(3))
def test_inverse4_equals_numpys_inverse(seed):
    """inverse4 gives np.linalg.inv's float32 bits (a float64 LU inverse
    rounded once), the inverse the host computed before the step moved to
    the device, on poses, nearly orthonormal ones and poses far from the
    origin; the JAX package's float32 inverse differs from both by a few
    ulps at some entries (its LU runs in float32)."""
    rng = np.random.default_rng(10 + seed)
    inv = jax.jit(jnp.linalg.inv)
    differ = 0
    for i, m in enumerate(_rotations(rng, 1000)):
        if i % 3 == 1:
            m[:3, :3] += (rng.normal(size=(3, 3)) * 1e-6).astype(np.float32)
        if i % 5 == 2:
            m[:3, 3] *= np.float32(100.0)
        ours = inverse4(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(ours, np.linalg.inv(m))
        jax_inv = np.asarray(inv(m))
        # float32 LU against float64: within 4 ulps of the largest entry
        # (measured 3)
        np.testing.assert_allclose(ours, jax_inv, rtol=0,
                                   atol=4 * np.spacing(np.abs(jax_inv).max()))
        differ += not np.array_equal(ours, jax_inv)
    assert differ > 0


# ----------------------------------------------------------------------
# the tracked frame through the cache, against the eager step and JAX
# ----------------------------------------------------------------------
@pytest.mark.parametrize("scale", [1, 2])
def test_track_fuse_through_the_cache_equals_the_eager_step(scale):
    """Nine frames with one lost, through the stub capturer's cache and
    eagerly: the same poses, ok flags and volume bit for bit; frame 0
    and the two staging slots of the tracked step are the keys."""
    stub = StubCapture()
    cached = _slam(graphs=StepGraphs("cpu", capture=stub), track_res_scale=scale)
    eager = _slam(capture=False, track_res_scale=scale)
    depths = _depths()
    (cp, cok), (ep, eok) = _run(cached, depths), _run(eager, depths)
    np.testing.assert_array_equal(cp, ep)
    assert cok == eok and cok[LOST] is False and sum(cok) == len(SEQ) - 1
    # the lost frame keeps the previous pose, and fuses with it
    np.testing.assert_array_equal(cp[LOST], cp[LOST - 1])
    _assert_volumes_equal(cached.volume, eager.volume)
    assert cached.lost_count == eager.lost_count == 1
    kinds = sorted(k[0] for k in cached.graphs.keys())
    assert kinds == ["integrate", "track_fuse", "track_fuse"] and len(stub.bodies) == 3
    assert cached.graphs.replays == len(SEQ) - 3


def test_the_sequence_matches_jax_and_its_lost_count():
    """The same nine frames through the JAX DenseSLAM: the same ok flags
    and lost_count, poses within POSE_TOL (test_torch_dense_slam's)."""
    depths = _depths()
    port = _slam()
    jax_slam = JSLAM(K, H, W, voxel_size=0.02, truncation=0.06, cfg=SLAM_CFG,
                     splat_impl="xla")
    (tp, tok), (jp, jok) = _run(port, depths), _run(jax_slam, depths)
    assert tok == jok
    assert port.lost_count == jax_slam.lost_count == 1
    np.testing.assert_allclose(tp, jp, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(port.world_T_cam, np.asarray(jax_slam.world_T_cam), rtol=0,
                               atol=POSE_TOL)
    a, b = volume_fingerprint(port_arrays(port.volume)), volume_fingerprint(
        jax_arrays(jax_slam.volume))
    assert a["active_blocks"] == b["active_blocks"]


def test_world_T_cam_is_a_device_buffer_written_in_place():
    """The pose lives in one [4, 4] float32 buffer: the setter copies into
    it (a captured step keeps its address), the getter returns a host
    copy."""
    slam = _slam()
    buf = slam._pose
    m = _random_pose(np.random.default_rng(3))
    slam.world_T_cam = m
    assert slam._pose is buf and buf.dtype == torch.float32 and buf.shape == (4, 4)
    got = slam.world_T_cam
    np.testing.assert_array_equal(got, m)
    got[0, 0] = 7.0
    assert float(buf[0, 0]) == m[0, 0]


class _Reads:
    """Counts the host reads of tensors: Tensor.cpu, .item, .numpy,
    .tolist and __bool__, outside the ICP kernel's plain version (the CPU's
    stand-in for csrc/icp_step.cu, which takes its sequential sums and its
    solve on the host; on the card the kernel reads nothing)."""

    NAMES = ("cpu", "item", "numpy", "tolist", "__bool__")

    def __init__(self, monkeypatch):
        from disinfect_slam_tpu_torch.ops.cuda import icp_kernel

        self.n = 0
        for name in self.NAMES:
            real = getattr(torch.Tensor, name)

            def counted(t, *a, _real=real, **k):
                self.n += 1
                return _real(t, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, counted)
        plain = icp_kernel.icp_step_reference

        def uncounted(*a, **k):
            n = self.n
            out = plain(*a, **k)
            self.n = n
            return out

        monkeypatch.setattr(icp_kernel, "icp_step_reference", uncounted)


def test_tracked_frames_read_nothing_and_keyframes_once(monkeypatch):
    """With loop closure every 4th frame (no candidate old enough to
    verify), process_frame reads the device once on a keyframe (the gate,
    the pose and the match scores in one copy) and never on the other
    frames, lost or not; lost_count then reads the pending flags."""
    slam = _slam(loop_closure=True, kf_every=4, lc_kwargs=dict(min_gap_frames=1000))
    depths = _depths()
    reads = _Reads(monkeypatch)
    per_frame = []
    for d in depths:
        before = reads.n
        slam.process_frame(RGB, d)
        per_frame.append(reads.n - before)
    assert per_frame == [1 if i % 4 == 0 else 0 for i in range(len(SEQ))]
    assert slam.lc.count == 3 and slam.lc.verifications == 0
    before = reads.n
    assert slam.lost_count == 1 and reads.n > before


# ----------------------------------------------------------------------
# the tracker's own captured steps, and the loop closure's match
# ----------------------------------------------------------------------
def test_icp_captured_prep_and_track_equal_the_raw_ones():
    """ICPOdometry.prep / track through the cache give _prep / _track's
    bits (fresh tensors each call), and feed through them equals the
    eager feed frame by frame."""
    kw = dict(max_rmse=0.08, device="cpu")
    cached = odometry.ICPOdometry(K, H, W, graphs=StepGraphs("cpu", capture=StubCapture()),
                                  **kw)
    eager = odometry.ICPOdometry(K, H, W, capture=False, **kw)
    d0, d1 = scene_depth(ORBIT[0]), scene_depth(ORBIT[1])
    pyr = [cached.prep(d) for d in (d0, d1)]
    raw = [cached._prep(torch.from_numpy(d)) for d in (d0, d1)]
    for p, r in zip(pyr, raw):
        for lv_p, lv_r in zip(p, r):
            assert all(torch.equal(a, b) for a, b in zip(lv_p, lv_r))
    seed, ref = torch.eye(4), torch.eye(4)
    out = cached.track(seed, pyr[1], pyr[0], ref)
    want = cached._track(seed, raw[1], raw[0], ref)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    for pose in ORBIT[:4]:
        (cp, cok), (ep, eok) = cached.feed(scene_depth(pose)), eager.feed(scene_depth(pose))
        np.testing.assert_array_equal(cp, ep)
        assert cok == eok
    assert cached.graphs.replays > 0


def test_keyframe_query_matches_the_device_match():
    """The host-side best match from a query's scores equals the device
    match (_match_scores) for recency gaps that mask none, some and all
    keyframes, and for relocalization's no-gap search."""
    lc = LoopClosureManager(K, H, W, kf_every=1, min_gap_frames=0, device="cpu")
    for i, pose in enumerate(ORBIT):
        lc.add_keyframe(scene_depth(pose), np.linalg.inv(pose), frame_id=10 * i,
                        intensity=RGB.mean(-1))
    q = lc.query(scene_depth(ORBIT[2]), RGB.mean(-1))
    host = q._replace(scores=q.scores.numpy().copy())
    for cur_id, gap in ((100, 0), (60, 25), (60, 1000), (0, -(10**9))):
        assert lc._best_match(q.desc, cur_id, gap, host.scores) == lc._best_match(
            q.desc, cur_id, gap)


# ----------------------------------------------------------------------
# the sharded step
# ----------------------------------------------------------------------
SHARD_POSE = look_at((0.021, -0.017, 0.009), (0.05, 0.08, 2.0))


def _shard_frames():
    near = make_frame(render_wall(IW, IH, IK, SHARD_POSE, wall_z=1.0137))
    far = make_frame(render_wall(IW, IH, IK, SHARD_POSE, wall_z=3.0219))
    return [near, near, far, far, far]


def _port_cfg(cfg):
    return TSDFConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("n", [4, 1])
@pytest.mark.parametrize("cfg", [CFG_DENSE, CFG_HASH], ids=["dense", "hash"])
def test_sharded_step_through_the_cache_equals_the_eager_step(cfg, n):
    """DistributedTSDF.integrate with its shards' steps through the stub
    capturer's cache (one step for the device's shards) against the eager
    step: every shard's arrays bit for bit and the capacity cuts of every
    frame equal, frames carving what the first ones fused."""
    cfg = _port_cfg(cfg)
    cached = ts.DistributedTSDF(cfg, ["cpu"] * n)
    stub = StubCapture()
    cached.graphs = {dev: StepGraphs(dev, capture=stub) for dev in cached.graphs}
    eager = ts.DistributedTSDF(cfg, ["cpu"] * n, capture=False)
    for frame in _shard_frames():
        cuts = {}
        for name, dist in (("cached", cached), ("eager", eager)):
            cuts[name] = []
            dist.integrate(_host_frame(frame), IK, SHARD_POSE, MAX_DEPTH, cuts=cuts[name])
        assert len(cuts["cached"]) == n
        for a, b in zip(cuts["cached"], cuts["eager"]):
            assert [None if t is None else int(t) for t in a] == [
                None if t is None else int(t) for t in b]
    assert len(stub.bodies) == 2 and cached.graphs[torch.device("cpu")].replays == 3
    for a, b in zip(cached.shards, eager.shards):
        _assert_volumes_equal(a, b)
    assert cached.num_active_blocks() == eager.num_active_blocks() > 0


def _host_frame(frame):
    """The test frame's fields as host arrays (ht and lt None: ones)."""
    from disinfect_slam_tpu_torch.ops.integrate import FrameInput

    return FrameInput(np.asarray(frame.rgb), np.asarray(frame.depth), None, None)


# ----------------------------------------------------------------------
# a capture that fails raises
# ----------------------------------------------------------------------
def _raising(body):
    raise RuntimeError("capture refused")


def test_a_failing_capture_raises():
    """A capturer that raises makes the tracked step, frame 0's step, the
    tracker's steps and the sharded step raise: nothing drops to eager."""
    slam = _slam(graphs=StepGraphs("cpu", capture=_raising))
    with pytest.raises(RuntimeError, match="capture refused"):
        slam.process_frame(RGB, scene_depth(ORBIT[0]))
    icp = odometry.ICPOdometry(K, H, W, device="cpu",
                               graphs=StepGraphs("cpu", capture=_raising))
    with pytest.raises(RuntimeError, match="capture refused"):
        icp.feed(scene_depth(ORBIT[0]))
    dist = ts.DistributedTSDF(_port_cfg(CFG_DENSE), ["cpu"] * 2)
    dist.graphs = {dev: StepGraphs(dev, capture=_raising) for dev in dist.graphs}
    with pytest.raises(RuntimeError, match="capture refused"):
        dist.integrate(_host_frame(_shard_frames()[0]), IK, SHARD_POSE, MAX_DEPTH)
    # the tracked step itself, after an eager frame 0
    slam = _slam()
    slam.process_frame(RGB, scene_depth(ORBIT[0]))
    slam._step.graphs = StepGraphs("cpu", capture=_raising)
    with pytest.raises(RuntimeError, match="capture refused"):
        slam.process_frame(RGB, scene_depth(ORBIT[1]))


def test_mark_sees_the_stages_of_the_eager_step_only():
    """mark(name) is called at each of STAGES on the eager step; the
    captured step refuses it."""
    seen = []
    slam = _slam(capture=False)
    slam.process_frame(RGB, scene_depth(ORBIT[0]))
    slam.process_frame(RGB, scene_depth(ORBIT[1]), mark=seen.append)
    assert tuple(seen) == tds.STAGES
    cached = _slam(graphs=StepGraphs("cpu", capture=StubCapture()))
    cached.process_frame(RGB, scene_depth(ORBIT[0]))
    with pytest.raises(ValueError, match="eager"):
        cached.process_frame(RGB, scene_depth(ORBIT[1]), mark=seen.append)
