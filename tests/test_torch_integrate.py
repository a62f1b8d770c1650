"""PyTorch port, integration: several frames of the golden wall and
sphere scenes through the port and through the JAX package
(sampler="gather", the exact path), with allocation every frame and
every third frame; the port against the numpy oracle; and a volume
carried across the two packages through a checkpoint."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.core.geometry import SE3 as JSE3
from disinfect_slam_tpu.core.geometry import CameraIntrinsics as JIntr
from disinfect_slam_tpu.core.geometry import CameraParams as JCam
from disinfect_slam_tpu.core.state import TSDFVolume as JVolume
from disinfect_slam_tpu.io import checkpoint as jckpt
from disinfect_slam_tpu.ops.integrate import FrameInput as JFrame
from disinfect_slam_tpu.ops.integrate import integrate as j_integrate
from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics, CameraParams
from disinfect_slam_tpu_torch.core.state import TSDFVolume
from disinfect_slam_tpu_torch.io import checkpoint as tckpt
from disinfect_slam_tpu_torch.ops.integrate import FrameInput, integrate

from .oracle import OracleVolume
from .scenes import checker_rgb, look_at, render_sphere, render_wall
from .test_integrate import CFG_DENSE, H, K, MAX_DEPTH, W, compare
from .test_torch_hash import jax_arrays, port_arrays, port_cfg

torch.set_num_threads(1)

CFG = dataclasses.replace(CFG_DENSE, sampler="gather", max_visible=256)


def _scene(name: str, n: int):
    """n frames of (rgb, depth, ht, lt, cam_T_world) from a slow orbit."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        if name == "wall":
            eye = (0.03 + 0.021 * i, -0.041 + 0.013 * i, 0.017 - 0.009 * i)
            pose = look_at(eye, (0.11, 0.07, 2.0131))
            depth = render_wall(W, H, K, pose, wall_z=2.0131)
        else:  # test_integrate.py's sphere orbit
            ang = 0.13 * i - 0.12
            eye = (np.sin(ang) * 2.5 + 0.013, 0.1 * i - 0.027,
                   -2.5 * np.cos(ang) + 1.0)
            pose = look_at(eye, (0.013, -0.021, 1.007))
            depth = render_sphere(W, H, K, pose, (0.013, -0.021, 1.007), 0.613)
        ht = rng.uniform(0.05, 0.95, (H, W)).astype(np.float32)
        lt = rng.uniform(0.05, 0.95, (H, W)).astype(np.float32)
        out.append((checker_rgb(W, H), depth, ht, lt, pose.astype(np.float32)))
    return out


@jax.jit
def _j_step(vol, frame, pose):
    cam = JCam.create(JIntr.create(*K), H, W)
    return j_integrate(vol, frame, cam, JSE3.from_matrix(pose), MAX_DEPTH)


@jax.jit
def _j_step_no_alloc(vol, frame, pose):
    cam = JCam.create(JIntr.create(*K), H, W)
    return j_integrate(vol, frame, cam, JSE3.from_matrix(pose), MAX_DEPTH,
                       allocate=False)


def _run_jax(frames, cfg, alloc_every=1, vol=None):
    vol = JVolume.create(cfg) if vol is None else vol
    for i, (rgb, depth, ht, lt, pose) in enumerate(frames):
        fr = JFrame(*(jnp.asarray(a) for a in (rgb, depth, ht, lt)))
        step = _j_step if i % alloc_every == 0 else _j_step_no_alloc
        vol = step(vol, fr, jnp.asarray(pose))
    return vol


def _run_port(frames, cfg, alloc_every=1, vol=None):
    cam = CameraParams.create(CameraIntrinsics.create(*K), H, W)
    vol = TSDFVolume.create(cfg) if vol is None else vol
    for i, (rgb, depth, ht, lt, pose) in enumerate(frames):
        fr = FrameInput(*(torch.from_numpy(a) for a in (rgb, depth, ht, lt)))
        vol = integrate(vol, fr, cam, SE3.from_matrix(pose), MAX_DEPTH,
                        allocate=i % alloc_every == 0)
    return vol


def assert_matches_jax(vol_t, vol_j):
    """Same live blocks in the same pool rows, equal rgbw words, tsdf and
    prob within 1e-5.  The tolerance covers XLA:CPU's FMA contraction
    and its own exp/log inside the jitted JAX step; the port contracts
    nothing (ulp-level differences that fusion accumulates over frames)."""
    a, b = port_arrays(vol_t), jax_arrays(vol_j)
    for f in ("entry_key", "entry_block", "block_table", "heap", "num_free",
              "oob_count", "rgbw"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    rows = b["entry_block"][b["entry_block"] >= 0]
    assert rows.size > 10
    for f in ("tsdf", "prob"):
        np.testing.assert_allclose(a[f][rows], b[f][rows], rtol=0, atol=1e-5,
                                   err_msg=f)


@pytest.mark.parametrize("alloc_every", [1, 3])
@pytest.mark.parametrize("scene", ["wall", "sphere"])
def test_integrate_matches_jax_gather(scene, alloc_every):
    frames = _scene(scene, 4)
    vol_t = _run_port(frames, port_cfg(CFG), alloc_every)
    vol_j = _run_jax(frames, CFG, alloc_every)
    assert_matches_jax(vol_t, vol_j)


def test_two_stage_sampler_equals_fused_path_on_cpu():
    """sampler="gather" (sample + torch fusion math) and the fused path
    run the same formulas: identical volumes."""
    frames = _scene("sphere", 3)
    cfg = port_cfg(CFG)
    a = port_arrays(_run_port(frames, cfg))
    b = port_arrays(_run_port(frames, dataclasses.replace(cfg, sampler="pallas_fused")))
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_integrate_matches_oracle():
    """The port against tests/oracle.py with test_integrate.py's own
    comparison (the volume is handed to it in the JAX layout)."""
    frames = _scene("wall", 3)
    vol_t = _run_port(frames, port_cfg(CFG))
    ovol = OracleVolume(CFG.voxel_size, CFG.truncation)
    for rgb, depth, ht, lt, pose in frames:
        ovol.integrate(rgb, depth, ht, lt, MAX_DEPTH, K, pose.astype(np.float64))
    vol_as_j = JVolume(cfg=CFG, **{f: jnp.asarray(v) for f, v in port_arrays(vol_t).items()})
    compare(vol_as_j, ovol)


def test_checkpoint_carries_state_across_packages(tmp_path):
    """Fuse frames in JAX, carry the volume over through the JAX
    checkpoint, fuse one more frame in both packages; and back."""
    frames = _scene("sphere", 4)
    vol_j = _run_jax(frames[:3], CFG)
    path = str(tmp_path / "vol.npz")
    jckpt.save_volume(path, vol_j)
    vol_t = tckpt.load_volume(path)
    assert vol_t.cfg == port_cfg(CFG)
    vol_t = _run_port(frames[3:], vol_t.cfg, vol=vol_t)
    vol_j = _run_jax(frames[3:], CFG, vol=vol_j)
    assert_matches_jax(vol_t, vol_j)

    back = str(tmp_path / "port.npz")
    tckpt.save_volume(back, vol_t)
    loaded = jckpt.load_volume(back)
    assert loaded.cfg == CFG
    for f, v in port_arrays(vol_t).items():
        np.testing.assert_array_equal(np.asarray(getattr(loaded, f)), v, err_msg=f)
