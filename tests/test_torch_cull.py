"""PyTorch port, the occlusion cull (cfg.cull_occluded): the port's mask
against the JAX package's _occluded_blocks on the same volume and frame,
the port's fused volumes with the cull on and off, the port against the
JAX package with the cull on, and the visible set it shrinks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.core.geometry import SE3 as JSE3
from disinfect_slam_tpu.core.geometry import CameraIntrinsics as JIntr
from disinfect_slam_tpu.core.geometry import CameraParams as JCam
from disinfect_slam_tpu.ops import integrate as jint
from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics, CameraParams
from disinfect_slam_tpu_torch.core.state import TSDFVolume
from disinfect_slam_tpu_torch.ops import integrate as tint

from .scenes import look_at, render_wall
from .test_cull import occluded_scene
from .test_integrate import CFG_DENSE, H, K, MAX_DEPTH, W, make_frame
from .test_torch_hash import port_arrays, port_cfg, port_from_jax
from .test_torch_integrate import _run_jax, assert_matches_jax

torch.set_num_threads(1)

CFG_ON = dataclasses.replace(CFG_DENSE, cull_occluded=True, sampler="gather")
CFG_OFF = dataclasses.replace(CFG_ON, cull_occluded=False)
TARGET = (0.013, -0.021, 1.2)
# eyes of the frames: two viewpoints, so that wall blocks behind the
# sphere are allocated from one and occluded in the other
EYES = [(-0.6, 0.0, -1.3), (0.6, 0.05, -1.3), (-0.6, 0.0, -1.3), (0.6, 0.05, -1.3)]


def _frames(eyes):
    out = []
    for eye in eyes:
        pose = look_at(eye, TARGET).astype(np.float32)
        fr = make_frame(occluded_scene(pose))
        out.append(tuple(np.array(a) for a in fr) + (pose,))
    return out


def _run_port(frames, cfg):
    cam = CameraParams.create(CameraIntrinsics.create(*K), H, W)
    vol = TSDFVolume.create(port_cfg(cfg), device="cpu")
    for rgb, depth, ht, lt, pose in frames:
        fr = tint.FrameInput(*(torch.from_numpy(a) for a in (rgb, depth, ht, lt)))
        vol = tint.integrate(vol, fr, cam, SE3.from_matrix(pose), MAX_DEPTH)
    return vol


def _wall_volume(pose):
    """The JAX package's volume after a wall-only frame (far wall blocks
    allocated), as test_cull.py builds it."""
    wall = [tuple(np.array(a) for a in make_frame(render_wall(W, H, K, pose, wall_z=2.4131)))
            + (pose,)]
    return _run_jax(wall, CFG_ON)


@pytest.mark.parametrize("eye", [(0.013, -0.021, -1.3), (-0.6, 0.0, -1.3), (0.35, 0.2, -1.1)])
def test_occluded_mask_matches_jax(eye):
    """The same volume and frame through both culls: equal masks over
    every entry, and some blocks culled."""
    pose = look_at(eye, TARGET).astype(np.float32)
    vol_j = _wall_volume(pose)
    depth = occluded_scene(pose)
    j_cam = JCam.create(JIntr.create(*K), H, W)
    j_pose = JSE3.from_matrix(jnp.asarray(pose))
    j_mask = np.asarray(jax.jit(jint._occluded_blocks, static_argnums=(5,))(
        vol_j.entry_pos, j_cam, j_pose, jnp.asarray(depth), jint.depth_to_range(j_cam),
        CFG_ON))

    vol_t = port_from_jax(vol_j)
    cam = CameraParams.create(CameraIntrinsics.create(*K), H, W)
    t_mask = tint.occluded_blocks(vol_t.entry_pos, cam, SE3.from_matrix(pose),
                                  torch.from_numpy(depth), tint.depth_to_range(cam, "cpu"),
                                  vol_t.cfg).numpy()
    np.testing.assert_array_equal(t_mask, j_mask)
    live = np.asarray(vol_j.entry_block) >= 0
    assert (t_mask & live).sum() > 0


def test_cull_leaves_the_volume_bit_equal():
    """Fusion with the cull and without it: the same volume, bit for bit
    (index, free list and payloads), with blocks culled on the last
    frame."""
    frames = _frames(EYES)
    vol = _run_port(frames, CFG_ON)
    on = port_arrays(vol)
    off = port_arrays(_run_port(frames, CFG_OFF))
    cam = CameraParams.create(CameraIntrinsics.create(*K), H, W)
    se3 = SE3.from_matrix(frames[-1][4])
    culled = tint.gather_visible(vol, cam, se3, torch.from_numpy(frames[-1][1]),
                                 tint.depth_to_range(cam, "cpu"))
    assert int(culled.count) < int(tint.gather_visible(vol, cam, se3).count)
    assert (on["entry_block"] >= 0).sum() > 20
    for f in on:
        np.testing.assert_array_equal(on[f], off[f], err_msg=f)


def test_cull_matches_jax():
    """The port and the JAX package with the cull on, over the same
    frames: test_torch_integrate.py's limits (same blocks in the same
    rows, equal rgbw words, tsdf and prob within 1e-5)."""
    frames = _frames(EYES)
    assert_matches_jax(_run_port(frames, CFG_ON), _run_jax(frames, CFG_ON))


def test_cull_shrinks_the_visible_set():
    """On the wall volume seen through the sphere, the culled visible set
    is smaller than the plain one, and a subset of it in the same order."""
    pose = look_at((0.013, -0.021, -1.3), TARGET).astype(np.float32)
    vol = port_from_jax(_wall_volume(pose))
    cam = CameraParams.create(CameraIntrinsics.create(*K), H, W)
    se3 = SE3.from_matrix(pose)
    depth = torch.from_numpy(occluded_scene(pose))
    plain = tint.gather_visible(vol, cam, se3)
    culled = tint.gather_visible(vol, cam, se3, depth, tint.depth_to_range(cam, "cpu"))
    n, m = int(plain.count), int(culled.count)
    assert 0 < m < n, (m, n)
    kept = culled.entry_idx[:m].numpy()
    assert np.isin(kept, plain.entry_idx[:n].numpy()).all()
    assert (np.diff(kept) > 0).all()
