"""PyTorch port, meshing: marching tetrahedra against the JAX package on
tests/test_mesh.py's sphere volume (the hash backend) and on a fused
golden wall scene (the dense backend), single-shot and chunked, f32 and
q16; the weld, the clip warning, the vertex attributes and the PLY / OBJ
writers.  The JAX volumes are carried into the port with
io/checkpoint.volume_from_numpy, so the comparison isolates meshing."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from disinfect_slam_tpu.core.state import TSDFVolume as JVolume
from disinfect_slam_tpu.ops import mesh as jmesh
from disinfect_slam_tpu_torch.ops import mesh as tmesh

from .scenes import look_at, render_sphere
from .test_integrate import CFG_DENSE, H, K, W, make_frame
from .test_mesh import CENTER, RADIUS
from .test_raycast import fuse_frames
from .test_torch_hash import port_from_jax
from .test_torch_integrate import _run_jax, _scene

torch.set_num_threads(1)

# vertices row for row within 1e-6 m against the chunked JAX mesh, whose
# jitted program lets XLA:CPU contract the interpolation
# pa + alpha * (pb - pa) into a fused multiply-add; the single-shot JAX
# mesh runs op by op, with no contraction, and is held bit for bit
ATOL = 1e-6
SINGLE = 1 << 15
CHUNKED = dict(chunk=16, max_tris_per_chunk=1 << 14)  # a chunk of 16 blocks holds < 5000


@pytest.fixture(scope="module")
def volumes():
    """{name: (JAX volume, port volume)}: test_mesh.py's sphere (8 views,
    hash backend) and the wall scene of test_torch_integrate.py (4
    frames, dense backend)."""
    frames = []
    for ang in np.linspace(0, 2 * np.pi, 8, endpoint=False):
        eye = CENTER + np.array([np.sin(ang) * 2.5, 0.05, -np.cos(ang) * 2.5])
        pose = look_at(eye, CENTER)
        frames.append((make_frame(render_sphere(W, H, K, pose, center=CENTER,
                                                radius=RADIUS)), pose))
    sphere, _ = fuse_frames(frames)
    wall = _run_jax(_scene("wall", 4), dataclasses.replace(CFG_DENSE, sampler="gather"))
    return {name: (v, port_from_jax(v)) for name, v in (("sphere", sphere), ("wall", wall))}


@pytest.fixture(scope="module")
def jax_meshes(volumes):
    """The JAX package's meshes, computed once (its chunked extraction
    compiles anew on every call, so the wall scene takes the single-shot
    mesh, the sphere every variant): single-shot
    (max_tris 2^15, above both scenes' counts), chunked f32 and q16 (16
    blocks, 2^14 triangles a chunk), and a run clipped at 256 triangles a
    chunk."""
    out = {name: {"single": jmesh.compact_mesh(jmesh.extract_mesh(v[0], max_tris=SINGLE))}
           for name, v in volumes.items()}
    vol_j = volumes["sphere"][0]
    out["sphere"]["f32"] = jmesh.extract_mesh_chunked(vol_j, **CHUNKED)
    out["sphere"]["q16"] = jmesh.extract_mesh_chunked(vol_j, transfer="q16", **CHUNKED)
    with tmesh.counting_clips("disinfect_slam_tpu.ops.mesh") as clipped:
        clip = jmesh.extract_mesh_chunked(vol_j, max_tris_per_chunk=256, chunk=64)
    out["sphere"]["clip"] = (clip, clipped[0])
    return out


def _normals(t):
    return np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])


def assert_tris_match(ours, ref):
    """Same triangle count, vertices row for row within ATOL, and no
    triangle wound the other way."""
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)
    n_o, n_r = _normals(ours.astype(np.float64)), _normals(ref.astype(np.float64))
    big = np.linalg.norm(n_r, axis=-1) > 1e-10
    assert ((n_o * n_r).sum(-1)[big] > 0).all()


@pytest.mark.parametrize("scene", ["sphere", "wall"])
def test_single_shot_mesh_matches_jax(volumes, jax_meshes, scene):
    mesh = tmesh.extract_mesh(volumes[scene][1], max_tris=SINGLE)
    ours = tmesh.compact_mesh(mesh)
    assert SINGLE > int(mesh.count) == mesh.valid.sum().item() > 300
    ref = jax_meshes[scene]["single"]
    np.testing.assert_array_equal(ours, ref)
    v, f = tmesh.merge_vertices(ours)
    v_j, f_j = jmesh.merge_vertices(ref)
    np.testing.assert_array_equal(v, v_j)
    np.testing.assert_array_equal(f, f_j)


@pytest.mark.parametrize("scene,transfer", [("sphere", "f32"), ("sphere", "q16")])
def test_chunked_mesh_matches_jax(volumes, jax_meshes, scene, transfer):
    ours = tmesh.extract_mesh_chunked(volumes[scene][1], transfer=transfer, **CHUNKED)
    ref = jax_meshes[scene][transfer]
    assert_tris_match(ours, ref)
    # the weld rounds to 1e-5 m: an FMA's ulp can move a vertex across a
    # rounding edge, so the counts agree within 0.1% (chip_smoke.py's
    # limit on the bench mesh)
    v, f = tmesh.merge_vertices(ours)
    v_j, f_j = jmesh.merge_vertices(ref)
    assert abs(len(v) - len(v_j)) <= 1e-3 * len(v_j)
    assert abs(len(f) - len(f_j)) <= 1e-3 * len(f_j)
    if transfer == "f32":
        # chunking changes nothing but the order of the blocks
        single = jax_meshes[scene]["single"]
        assert ours.shape == single.shape


@pytest.mark.parametrize("scene", ["sphere", "wall"])
def test_q16_within_a_32nd_of_a_voxel_of_f32(volumes, scene):
    vol = volumes[scene][1]
    f32 = tmesh.extract_mesh_chunked(vol, chunk=64, max_tris_per_chunk=SINGLE)
    q16 = tmesh.extract_mesh_chunked(vol, chunk=64, max_tris_per_chunk=SINGLE, transfer="q16")
    step = vol.cfg.voxel_size / 16.0
    assert q16.shape == f32.shape
    np.testing.assert_allclose(q16, f32, rtol=0, atol=step / 2 + 1e-6)


def test_clip_warning_fires_at_the_jax_chunk_count(volumes, jax_meshes, caplog):
    import logging

    ours_tris, ref = None, jax_meshes["sphere"]["clip"]
    with caplog.at_level(logging.WARNING, "disinfect_slam_tpu_torch.ops.mesh"):
        with tmesh.counting_clips() as clipped:
            ours_tris = tmesh.extract_mesh_chunked(volumes["sphere"][1],
                                                   max_tris_per_chunk=256, chunk=64)
    assert clipped[0] == ref[1] > 0
    assert any("clipped" in r.message for r in caplog.records)
    assert_tris_match(ours_tris, ref[0])


def test_vertex_attributes_match_jax(volumes, jax_meshes):
    vol_j, vol_t = volumes["wall"]
    verts, _ = jmesh.merge_vertices(jax_meshes["wall"]["single"])
    rgb, prob = tmesh.vertex_attributes(vol_t, verts)
    rgb_j, prob_j = jmesh.vertex_attributes(vol_j, verts)
    np.testing.assert_array_equal(rgb, rgb_j)
    np.testing.assert_array_equal(prob, prob_j)
    assert rgb.dtype == np.uint8 and prob.dtype == np.float32 and rgb.any()


@pytest.mark.parametrize("attrs", ["none", "rgb", "prob", "both"])
def test_ply_and_obj_bytes_equal_the_jax_writers(jax_meshes, tmp_path, attrs):
    verts, faces = jmesh.merge_vertices(jax_meshes["sphere"]["f32"])
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (len(verts), 3)).astype(np.uint8)
    prob = rng.uniform(0, 1, len(verts)).astype(np.float32)
    kw = {"rgb": rgb if attrs in ("rgb", "both") else None,
          "prob": prob if attrs in ("prob", "both") else None}
    paths = [str(tmp_path / f"{n}.ply") for n in ("ours", "ref")]
    tmesh.save_ply(paths[0], verts, faces, **kw)
    jmesh.save_ply(paths[1], verts, faces, **kw)
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1] and len(data[0]) > 1000
    if attrs == "none":
        for n, fn in (("ours", tmesh.save_obj), ("ref", jmesh.save_obj)):
            fn(str(tmp_path / f"{n}.obj"), verts, faces)
        obj = [open(str(tmp_path / f"{n}.obj"), "rb").read() for n in ("ours", "ref")]
        assert obj[0] == obj[1]
        assert os.path.getsize(str(tmp_path / "ours.obj")) > 1000


def test_empty_volume_meshes_to_nothing():
    vol = port_from_jax(JVolume.create(CFG_DENSE))
    assert tmesh.extract_mesh_chunked(vol).shape == (0, 3, 3)
    assert int(tmesh.extract_mesh(vol).count) == 0


def _merge_reference(tris, tol=1e-5):
    """The JAX package's weld as it is written: a row unique and
    np.add.at."""
    flat = tris.reshape(-1, 3)
    key = np.round(flat / tol).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    verts = np.zeros((len(uniq), 3), np.float64)
    counts = np.zeros(len(uniq), np.int64)
    np.add.at(verts, inv, flat)
    np.add.at(counts, inv, 1)
    verts /= np.maximum(counts[:, None], 1)
    faces = inv.reshape(-1, 3)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts.astype(np.float32), faces[good]


@pytest.mark.parametrize("scale", [1.0, 100.0], ids=["packed", "row_unique"])
def test_merge_vertices_equals_the_row_unique_weld(scale):
    """The one-key unique and bincount sums against the weld as the JAX
    package writes it, bit for bit: coords within +-10 m take the packed
    key, larger ones the row unique; welded duplicates and degenerate
    faces included."""
    rng = np.random.default_rng(2)
    tris = (rng.integers(-3000, 3000, (20000, 3, 3)) * 1e-4 * scale).astype(np.float32)
    tris[::5, 1] = tris[::5, 0]
    tris[1::7] = tris[::7][: len(tris[1::7])]
    ours, ref = tmesh.merge_vertices(tris), _merge_reference(tris)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert len(ours[1]) < len(tris)
