"""PyTorch port, the captured steps on the CPU: the device pose
(core/geometry.DevicePose) against the host pose (SE3) bit for bit;
integrate with the device pose against the host pose, on both backends
and both allocation cadences; the port's integrate_jit against the JAX
integrate run eagerly (bit for bit) and the JAX integrate_jit (within the
fingerprint limits); and utils/graphs.StepGraphs' keys, invalidation and
launch accounting through a stub capturer the tests pass in (on the CPU
the engine objects run their steps eagerly; the CUDA graphs themselves are
tested on the card, tests/test_torch_gpu.py)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.core.geometry import SE3 as JSE3
from disinfect_slam_tpu.core.geometry import CameraIntrinsics as JIntr
from disinfect_slam_tpu.core.geometry import CameraParams as JCam
from disinfect_slam_tpu.core.state import TSDFVolume as JVolume
from disinfect_slam_tpu.ops.gather import gather_valid as j_gather_valid
from disinfect_slam_tpu.ops.integrate import FrameInput as JFrame
from disinfect_slam_tpu.ops.integrate import integrate as j_integrate
from disinfect_slam_tpu.ops.integrate import integrate_jit as j_integrate_jit
from disinfect_slam_tpu_torch.core.geometry import (
    SE3, CameraIntrinsics, CameraParams, DevicePose, pose_floats,
)
from disinfect_slam_tpu_torch.core.state import TSDFVolume
from disinfect_slam_tpu_torch.ops.cuda import fuse_kernel
from disinfect_slam_tpu_torch.ops.gather import fingerprint_gaps, gather_valid, volume_fingerprint
from disinfect_slam_tpu_torch.ops.integrate import FrameInput, integrate, integrate_jit
from disinfect_slam_tpu_torch.systems.online_step import FusedOnlineStep
from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid
from disinfect_slam_tpu_torch.utils import graphs as g

from .test_integrate import CFG as CFG_HASH
from .test_torch_hash import jax_arrays, port_arrays, port_cfg
from .test_torch_integrate import CFG, H, K, MAX_DEPTH, W, _scene

torch.set_num_threads(1)

CAM = CameraParams.create(CameraIntrinsics.create(*K), H, W)


def _random_pose(rng) -> np.ndarray:
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    m = np.eye(4)
    m[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                 [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                 [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    m[:3, 3] = rng.normal(size=3) * 3.0
    return m.astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_device_pose_equals_the_host_pose(seed):
    """apply_xyz, rotate_xyz, rotate, apply of a pose and of its inverse:
    0-d float32 views give the bits the Python floats give."""
    rng = np.random.default_rng(seed)
    host = SE3.from_matrix(_random_pose(rng))
    dev = DevicePose.from_se3(host, "cpu")
    pts = torch.from_numpy((rng.normal(size=(2048, 3)) * 4.0).astype(np.float32))
    xyz = pts.unbind(-1)
    for a, b in ((host, dev), (host.inverse(), dev.inverse())):
        for x, y in zip(a.apply_xyz(*xyz), b.apply_xyz(*xyz)):
            assert torch.equal(x, y)
        for x, y in zip(a.rotate_xyz(*xyz), b.rotate_xyz(*xyz)):
            assert torch.equal(x, y)
        assert torch.equal(a.rotate(pts), b.rotate(pts))
        assert torch.equal(a.apply(pts), b.apply(pts))
    # the buffer holds SE3's own float32 arithmetic, both halves
    np.testing.assert_array_equal(dev.buf.numpy(), pose_floats(host))
    np.testing.assert_array_equal(dev.inverse().slots().numpy()[:16],
                                  pose_floats(host.inverse())[:16])
    assert dev.inverse().inverse().kernel_ptr() == dev.kernel_ptr()
    assert dev.inverse().kernel_ptr() == dev.kernel_ptr() + 64


@pytest.mark.parametrize("alloc_every", [1, 3])
@pytest.mark.parametrize("backend", ["dense", "hash"])
def test_integrate_with_the_device_pose_equals_the_host_pose(backend, alloc_every):
    """Four frames of the golden sphere orbit through integrate with an SE3
    and with a DevicePose: every array bit-equal (allocation on every
    frame, or on every third)."""
    cfg = port_cfg(CFG if backend == "dense" else dataclasses.replace(CFG_HASH,
                                                                       sampler="gather"))
    frames = _scene("sphere", 4)
    vols = [TSDFVolume.create(cfg, "cpu") for _ in range(2)]
    for i, (rgb, depth, ht, lt, pose) in enumerate(frames):
        fr = FrameInput(*(torch.from_numpy(a) for a in (rgb, depth, ht, lt)))
        se3 = SE3.from_matrix(pose)
        for vol, p in zip(vols, (se3, DevicePose.from_se3(se3, "cpu"))):
            integrate(vol, fr, CAM, p, MAX_DEPTH, allocate=i % alloc_every == 0)
    a, b = (port_arrays(v) for v in vols)
    assert (a["entry_block"] >= 0).sum() > 10
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _jax_eager(frames, cfg, semantics: bool):
    vol = JVolume.create(cfg)
    cam = JCam.create(JIntr.create(*K), H, W)
    for rgb, depth, ht, lt, pose in frames:
        if not semantics:
            ht = lt = np.ones_like(depth)
        fr = JFrame(*(jnp.asarray(a) for a in (rgb, depth, ht, lt)))
        with jax.disable_jit():
            vol = j_integrate(vol, fr, cam, JSE3.from_matrix(jnp.asarray(pose)), MAX_DEPTH)
    return vol


def _port_jit(frames, cfg, semantics: bool):
    vol = TSDFVolume.create(cfg, "cpu")
    for rgb, depth, ht, lt, pose in frames:
        sem = [torch.from_numpy(a) for a in (ht, lt)] if semantics else [None, None]
        out = integrate_jit(vol, FrameInput(torch.from_numpy(rgb), torch.from_numpy(depth), *sem),
                            (H, W), np.asarray(K, np.float32), MAX_DEPTH, pose)
        assert out is vol  # updated in place (the JAX entry donates it)
    return vol


@pytest.mark.parametrize("sampler", ["gather", "pallas_fused"])
@pytest.mark.parametrize("scene", ["wall", "sphere"])
def test_integrate_jit_equals_the_eager_jax_integrate(scene, sampler):
    """The port's integrate_jit against the JAX integrate run eagerly (no
    XLA fusion, so no contraction) on the same frames: every array bit for
    bit with ht = lt = 1; with the scene's semantics every array but prob
    bit for bit, and prob within 8 float32 ulps (torch's CPU exp and log
    against XLA:CPU's; measured 6)."""
    frames = _scene(scene, 3)
    cfg = dataclasses.replace(CFG, sampler="gather")
    pcfg = dataclasses.replace(port_cfg(cfg), sampler=sampler)
    for semantics in (False, True):
        a = port_arrays(_port_jit(frames, pcfg, semantics))
        b = jax_arrays(_jax_eager(frames, cfg, semantics))
        assert (a["entry_block"] >= 0).sum() > 10
        for f in a:
            if semantics and f == "prob":
                ulps = np.abs(a[f].view(np.int32).astype(np.int64) - b[f].view(np.int32))
                assert ulps.max() <= 8, ulps.max()
            else:
                np.testing.assert_array_equal(a[f], b[f], err_msg=f"{f} semantics={semantics}")


def test_integrate_jit_matches_the_jitted_jax_by_fingerprint():
    """The port's integrate_jit against the JAX integrate_jit (XLA:CPU
    contracts FMAs there: voxels at half-pixel ties take the other pixel)
    over the sphere orbit: within ops/gather.py's fingerprint limits."""
    frames = _scene("sphere", 4)
    vol = _port_jit(frames, port_cfg(CFG), True)
    jvol = JVolume.create(CFG)
    for rgb, depth, ht, lt, pose in frames:
        fr = JFrame(*(jnp.asarray(a) for a in (rgb, depth, ht, lt)))
        jvol = j_integrate_jit(jvol, fr, (H, W), jnp.asarray(K, jnp.float32), MAX_DEPTH,
                               jnp.asarray(pose))
    ours = volume_fingerprint(port_arrays(vol))
    ours["records"] = int(gather_valid(vol).count)
    ref = volume_fingerprint(jax_arrays(jvol))
    ref["records"] = int(j_gather_valid(jvol).count)
    assert ref["active_blocks"] > 10
    gaps = fingerprint_gaps(ours, ref)
    assert all(d <= tol for d, tol in gaps.values()), gaps


class StubCapture:
    """A capturer for the CPU: records each capture, and "replays" by
    running the recorded step's body again (what a CUDA graph of it would
    do).  Capture itself runs nothing, as a CUDA capture launches
    nothing."""

    def __init__(self):
        self.bodies = []

    def __call__(self, body):
        self.bodies.append(body)
        return body, None


def _grids(cfg, stub):
    return (TSDFGrid(0.05, 0.15, cfg=cfg, device="cpu",
                     graphs=g.StepGraphs("cpu", capture=stub)),
            TSDFGrid(0.05, 0.15, cfg=cfg, device="cpu", capture=False))


def _feed(grids, frames):
    for rgb, depth, ht, lt, pose in frames:
        for grid in grids:
            grid.integrate(rgb, depth, ht, lt, MAX_DEPTH, K, pose)


def _assert_same(a, b):
    a, b = port_arrays(a), port_arrays(b)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_step_keys_cadence_slots_and_replays():
    """alloc_every 3 over 8 frames: four keys (allocating or not, staging
    slot 0 or 1), each captured once after its first, eager call and
    replayed after it; the volume equals the eager grid's bit for bit."""
    stub = StubCapture()
    cached, eager = _grids(dataclasses.replace(port_cfg(CFG), alloc_every=3), stub)
    frames = _scene("sphere", 8)
    _feed((cached, eager), frames[:2])
    assert len(stub.bodies) == 2 and cached.graphs.replays == 0
    _feed((cached, eager), frames[2:])
    keys = cached.graphs.keys()
    assert len(keys) == len(stub.bodies) == 4
    assert {(k[6], k[8]) for k in keys} == {(True, 0), (False, 1), (True, 1), (False, 0)}
    assert cached.graphs.replays == 4
    _assert_same(cached.volume, eager.volume)


def test_a_new_storage_or_config_captures_again():
    """A recenter (a new directory tensor and config), a new volume
    assigned to the grid, and the same tensors under another config each
    key a new capture, whose first call runs eagerly; the volume stays
    equal to the eager grid's."""
    stub = StubCapture()
    cfg = port_cfg(CFG)
    cached, eager = _grids(cfg, stub)
    frames = _scene("wall", 8)
    _feed((cached, eager), frames[:3])
    assert len(stub.bodies) == 2 and cached.graphs.replays == 1
    for grid in (cached, eager):
        assert grid.recenter((0.5, 0.3, 1.0))
    _feed((cached, eager), frames[3:5])
    assert len(stub.bodies) == 4 and cached.graphs.replays == 1
    _assert_same(cached.volume, eager.volume)

    for grid in (cached, eager):
        grid.volume = grid.volume.clone()
    _feed((cached, eager), frames[5:6])
    assert len(stub.bodies) == 5
    _assert_same(cached.volume, eager.volume)

    for grid in (cached, eager):
        grid.volume = dataclasses.replace(
            grid.volume, cfg=dataclasses.replace(grid.volume.cfg, carve_threshold=0.85))
    _feed((cached, eager), frames[6:8])
    assert len(stub.bodies) == 7 and cached.graphs.replays == 1
    _assert_same(cached.volume, eager.volume)


def test_the_cpu_runs_steps_eagerly_and_the_cache_evicts():
    """Without a capturer (the CPU) a step runs eagerly on every call and
    nothing is kept; with one, at most max_graphs keys, the least recently
    used going first."""
    calls = []
    eager = g.StepGraphs("cpu")
    for _ in range(3):
        eager.run("k", lambda: calls.append(1))
    assert len(calls) == 3 and len(eager) == 0 and eager.captures == 0
    cache = g.StepGraphs("cpu", capture=StubCapture(), max_graphs=2)
    for k in ("a", "b", "a", "c"):
        cache.run(k, lambda: None)
    assert cache.keys() == ["a", "c"] and cache.captures == 3 and cache.replays == 1


def test_replays_add_the_launches_their_capture_recorded(monkeypatch):
    """A capture runs the kernel wrappers without launching anything: the
    counts it adds are taken back, and each replay adds them again (and to
    REPLAYS)."""
    monkeypatch.setattr(fuse_kernel.fuse_rows, "launches", 0)

    def body():
        for _ in range(2):  # a step that launches K2 twice
            g.count_launch(fuse_kernel.fuse_rows)

    def capture(step):
        step()  # as a capture runs the wrappers
        return (lambda: None), None

    cache = g.StepGraphs("cpu", capture=capture)
    before = dict(g.REPLAYS)
    cache.run("k", body)  # eager (2 launches), then captured (none)
    assert fuse_kernel.fuse_rows.launches == 2
    for _ in range(3):
        cache.run("k", body)
    assert fuse_kernel.fuse_rows.launches == 8
    assert g.REPLAYS["graph"] - before.get("graph", 0) == 3
    assert g.REPLAYS["fuse_rows"] - before.get("fuse_rows", 0) == 6


def test_launches_on_another_thread_during_a_capture_stay_theirs(monkeypatch):
    """A step with no counted kernel captured while another thread
    launches K2 (the online app segments on its main thread while
    DISINFSystem integrates on its own): the other thread's launches stay
    counted, and the replays add none."""
    import threading

    monkeypatch.setattr(fuse_kernel.fuse_rows, "launches", 0)
    started, done = threading.Event(), threading.Event()

    def other():
        started.wait()
        for _ in range(3):
            g.count_launch(fuse_kernel.fuse_rows)
        done.set()

    def capture(step):
        started.set()
        done.wait()  # the other thread launches during this capture
        step()
        return (lambda: None), None

    t = threading.Thread(target=other)
    t.start()
    cache = g.StepGraphs("cpu", capture=capture)
    cache.run("seg", lambda: None)
    t.join()
    for _ in range(2):
        cache.run("seg", lambda: None)
    assert fuse_kernel.fuse_rows.launches == 3


@pytest.mark.parametrize("alloc_every", [1, 3])
def test_online_step_through_the_cache_equals_the_eager_step(alloc_every):
    """FusedOnlineStep (no net) through a stub-captured cache against the
    eager step, u8 rgb and u16 depth from the host: the same volume; one
    key a (cadence, slot) pair."""
    cfg = dataclasses.replace(port_cfg(CFG), alloc_every=alloc_every)
    steps = [FusedOnlineStep(cfg, K, H, W, MAX_DEPTH, depth_factor=1000.0, device="cpu",
                             capture=c) for c in (True, False)]
    steps[0].graphs = g.StepGraphs("cpu", capture=StubCapture())
    for rgb, depth, _, _, pose in _scene("sphere", 7):
        for s in steps:
            s.step(rgb.astype(np.uint8), (depth * 1000.0).astype(np.uint16), pose)
    assert len(steps[0].graphs) == (2 if alloc_every == 1 else 4)
    assert steps[0].graphs.replays == 7 - len(steps[0].graphs)
    _assert_same(steps[0].volume, steps[1].volume)


def test_dot_nodes_reads_a_captured_raycast_graph():
    """dot_nodes on the DOT dump of a RaycastStep's graph captured on an
    H100 at 640x480 (tests/data/raycast_step_graph.dot): the pose's upload,
    superblock_bits, the tile counter's memset, the march and the four
    images' copies; edges are not nodes.  A cache that does not keep its
    graphs' structure refuses nodes()."""
    path = os.path.join(os.path.dirname(__file__), "data", "raycast_step_graph.dot")
    with open(path) as f:
        nodes = g.dot_nodes(f.read())
    kernels = [k for k in nodes if k.startswith("KERNEL")]
    assert sum(nodes.values()) == 8 and nodes["MEMCPY"] == 5 and nodes["MEMSET"] == 1
    assert len(kernels) == 2
    assert any("superblock_bits_kernel" in k for k in kernels)
    assert any("raycast_kernel" in k for k in kernels)
    with pytest.raises(ValueError):
        g.dot_nodes("digraph dot {\n}\n")
    with pytest.raises(ValueError):
        g.StepGraphs("cpu").nodes("k")
