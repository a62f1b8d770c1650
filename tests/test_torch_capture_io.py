"""PyTorch port, the captured stereo, seg and mesh steps on the CPU: the
stereo estimator (flat and pyramid), the rectifier's remap, the seg
engine and chunked meshing, each driven through utils/graphs.StepGraphs
with the stub capturer of tests/test_torch_graph.py (a "replay" runs the
recorded body again, on the static inputs the call has just filled).

Tolerances: the captured steps equal their eager twins (capture=False)
bit for bit over calls on different inputs.  Against the JAX package:
the stereo depth and the remap bit for bit (tests/test_torch_stereo.py,
tests/test_torch_image_ops.py); the seg maps of a narrow float32 net
within 1e-4 (tests/test_torch_seg.py's float32 limit on the logits;
the sigmoid and the resizes only shrink a gap); the chunked meshes row
for row within tests/test_torch_mesh.py's 1e-6 m.  A capturer that raises
makes every step raise: no step drops to eager by itself."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.models import segmentation as js
from disinfect_slam_tpu.ops import image_ops as jimg
from disinfect_slam_tpu.ops import mesh as jmesh
from disinfect_slam_tpu.ops import stereo as jstereo
from disinfect_slam_tpu_torch.models import segmentation as ts
from disinfect_slam_tpu_torch.ops import image_ops as timg
from disinfect_slam_tpu_torch.ops import mesh as tmesh
from disinfect_slam_tpu_torch.ops import stereo as tstereo
from disinfect_slam_tpu_torch.utils import graphs as g

from .test_integrate import CFG_DENSE
from .test_stereo import BASELINE, FX, make_pair
from .test_torch_graph import StubCapture
from .test_torch_hash import port_from_jax
from .test_torch_integrate import _run_jax, _scene
from .test_torch_mesh import ATOL, assert_tris_match
from .test_torch_seg import carried_pair

torch.set_num_threads(1)

MAX_DISP = 16
CALLS = 3


def _stub():
    stub = StubCapture()
    return stub, g.StepGraphs("cpu", capture=stub)


def _boom(body):
    raise RuntimeError("capture failed")


def _pairs():
    """CALLS seeded u8 pairs at 96x128 (tests/test_stereo.py's planes)."""
    out = []
    for seed in range(CALLS):
        left, right, _ = make_pair(96, 128, seed=seed)
        out.append(tuple((x * 255).astype(np.uint8) for x in (left, right)))
    return out


@pytest.mark.parametrize("method", ["flat", "pyramid"])
def test_stereo_estimator_captured_equals_eager_and_jax(method):
    """Host pairs through pinned staging (slots 0, 1, 0: two captures, one
    replay), then device tensors (a third key): each depth equal to the
    eager estimator's and to the jitted JAX estimator's."""
    stub, graphs = _stub()
    kw = dict(max_disp=MAX_DISP, method=method)
    cap = tstereo.StereoDepthEstimator(FX, BASELINE, device="cpu", graphs=graphs, **kw)
    eager = tstereo.StereoDepthEstimator(FX, BASELINE, device="cpu", capture=False, **kw)
    ref = jstereo.StereoDepthEstimator(FX, BASELINE, **kw)
    pairs = _pairs()
    for left, right in pairs:
        ours = cap(left, right)
        np.testing.assert_array_equal(ours, eager(left, right))
        np.testing.assert_array_equal(ours, ref(left, right))
    assert len(stub.bodies) == 2 and graphs.replays == 1
    assert (ours > 0).mean() > 0.3
    left, right = (torch.from_numpy(x) for x in pairs[0])
    dev = cap.depth_device(left, right)
    np.testing.assert_array_equal(dev.numpy(), eager(*pairs[0]))
    np.testing.assert_array_equal(cap.left_device().numpy(), pairs[0][0])
    assert len(stub.bodies) == 3
    keys = graphs.keys()
    assert {k[1] for k in keys} == {True, False}
    assert all(dict(k[5:]).get("method") == method for k in keys)


def _rectifier(**kw):
    k_l = np.array([[92.0, 0, 64.0], [0, 91.5, 48.0], [0, 0, 1]])
    k_r = np.array([[92.5, 0, 64.5], [0, 91.8, 48.3], [0, 0, 1]])
    dist = np.array([-0.28, 0.07, 0.0002, 0.00002, 0.0])
    rot = np.array([[1.0, -0.0015, -0.001], [0.0015, 1.0, -0.002], [0.001, 0.002, 1.0]])
    maps = timg.build_rectify_maps(k_l, dist, k_r, dist, rot, np.array([-0.12, 0.0002, 0.0003]),
                                   (128, 96))
    return timg.StereoRectifier(maps, device="cpu", **kw)


def test_rectifier_captured_equals_eager_and_jax():
    """rectify (a color left and a gray right view from the host) over
    CALLS pairs and rectify_device on tensors: equal to the eager remap
    and to the jitted JAX remap with the same maps."""
    stub, graphs = _stub()
    cap, eager = _rectifier(graphs=graphs), _rectifier(capture=False)
    remap = jax.jit(jimg.bilinear_remap)
    lx, ly, rx, ry = (jnp.asarray(m) for m in cap.maps[:4])
    rng = np.random.default_rng(4)
    for _ in range(CALLS):
        left = rng.uniform(0, 255, (96, 128, 3)).astype(np.float32)
        right = rng.uniform(0, 255, (96, 128)).astype(np.float32)
        ours = cap.rectify(left, right)
        for a, b in zip(ours, eager.rectify(left, right)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours[0], np.asarray(remap(jnp.asarray(left), lx, ly)))
        np.testing.assert_array_equal(ours[1], np.asarray(remap(jnp.asarray(right), rx, ry)))
    assert len(stub.bodies) == 2 and graphs.replays == 1
    dev = cap.rectify_device(torch.from_numpy(left), torch.from_numpy(right))
    for a, b in zip(dev, ours):
        np.testing.assert_array_equal(a.numpy(), b)


def test_seg_engine_captured_equals_eager_and_jax():
    """A narrow float32 UNet (random, tests/test_torch_seg.py's) on CALLS
    u8 frames and one float32 frame (a second key): the maps equal the
    eager engine's, and the JAX engine's within 1e-4."""
    jm, params, tm = carried_pair("unet", jnp.float32, torch.float32, 64, 128)
    stub, graphs = _stub()
    out_size = (90, 160)
    cap = ts.InferenceEngine(tm, out_size=out_size, graphs=graphs)
    eager = ts.InferenceEngine(tm, out_size=out_size, capture=False)
    ref = js.InferenceEngine(jm, params, out_size=out_size)
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (60, 80, 3), dtype=np.uint8) for _ in range(CALLS)]
    frames.append(frames[0].astype(np.float32))
    for rgb in frames:
        ours = cap.infer_one(rgb)
        for a, b, r in zip(ours, eager.infer_one(rgb), ref.infer_one(rgb)):
            assert a.shape == out_size and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
            assert np.abs(a - r).max() <= 1e-4
    assert len(stub.bodies) == 3 and graphs.replays == 1
    first = cap.infer_one(frames[0])  # the maps the caller holds are its own
    again = cap.infer_one(frames[1])
    assert not np.array_equal(first[0], again[0])
    np.testing.assert_array_equal(first[0], eager.infer_one(frames[0])[0])


@pytest.fixture(scope="module")
def wall():
    """tests/test_torch_mesh.py's wall scene (4 frames, dense backend):
    the JAX volume and the port's copy of it."""
    vol = _run_jax(_scene("wall", 4), dataclasses.replace(CFG_DENSE, sampler="gather"))
    return vol, port_from_jax(vol)


# the wall's 32 candidate blocks in 5 chunks of 7, the last one of 4;
# 2^13 triangles a chunk
CHUNKS = dict(chunk=7, max_tris_per_chunk=1 << 13)


@pytest.mark.parametrize("transfer", ["f32", "q16"])
def test_chunked_mesh_captured_equals_eager_and_jax(wall, transfer):
    """The candidate pass and the chunk body through the stub: two
    captures, the other chunks replays; twice with one MeshGraphs (the
    second call replays every step); equal to the eager extraction and
    to the JAX package's within 1e-6 m."""
    vol_j, vol = wall
    n = int(tmesh._candidates(vol).sum())
    assert n > 2 * CHUNKS["chunk"] and n % CHUNKS["chunk"], n
    n_chunks = -(-n // CHUNKS["chunk"])
    stub, graphs = _stub()
    mg = tmesh.MeshGraphs("cpu", graphs)
    ours = tmesh.extract_mesh_chunked(vol, transfer=transfer, graphs=mg, **CHUNKS)
    assert len(stub.bodies) == 2 and graphs.replays == n_chunks - 1
    eager = tmesh.extract_mesh_chunked(vol, transfer=transfer, capture=False, **CHUNKS)
    np.testing.assert_array_equal(ours, eager)
    again = tmesh.extract_mesh_chunked(vol, transfer=transfer, graphs=mg, **CHUNKS)
    np.testing.assert_array_equal(again, ours)
    assert len(stub.bodies) == 2 and graphs.replays == 2 * n_chunks
    ref = jmesh.extract_mesh_chunked(vol_j, transfer=transfer, **CHUNKS)
    assert ours.shape[0] > 300
    assert_tris_match(ours, ref)
    assert ATOL == 1e-6


def test_a_failed_capture_raises(wall):
    """A capturer that raises: every new step raises instead of running
    eagerly."""
    est = tstereo.StereoDepthEstimator(FX, BASELINE, max_disp=MAX_DISP, device="cpu",
                                       graphs=g.StepGraphs("cpu", capture=_boom))
    with pytest.raises(RuntimeError, match="capture failed"):
        est(*_pairs()[0])
    rect = _rectifier(graphs=g.StepGraphs("cpu", capture=_boom))
    with pytest.raises(RuntimeError, match="capture failed"):
        rect.rectify(np.zeros((96, 128), np.float32), np.zeros((96, 128), np.float32))
    _, _, tm = carried_pair("fast", jnp.float32, torch.float32, 64, 128)
    eng = ts.InferenceEngine(tm, graphs=g.StepGraphs("cpu", capture=_boom))
    with pytest.raises(RuntimeError, match="capture failed"):
        eng.infer_one(np.zeros((60, 80, 3), np.uint8))
    with pytest.raises(RuntimeError, match="capture failed"):
        tmesh.extract_mesh_chunked(wall[1], graphs=tmesh.MeshGraphs(
            "cpu", g.StepGraphs("cpu", capture=_boom)), **CHUNKS)
