"""The synthetic orbit scene of the benchmark, as numpy frames
(counterpart of bench.py's make_orbit_frames and the scene helpers of
tests/scenes.py, restated so that the port loads neither): a sphere in
front of a back wall, a checkerboard colour, and a camera swinging on an
arc around the sphere.  apps.serve --synthetic N replays it.
"""

from __future__ import annotations

import numpy as np


def look_at(eye, target, up=(0, -1, 0)) -> np.ndarray:
    """cam_T_world float64 [4, 4] of a camera at eye looking at target
    (+z forward)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    world_T_cam = np.eye(4)
    world_T_cam[:3, 0] = right
    world_T_cam[:3, 1] = down
    world_T_cam[:3, 2] = fwd
    world_T_cam[:3, 3] = eye
    return np.linalg.inv(world_T_cam)


def render_wall(w, h, K, cam_T_world, wall_z=2.0) -> np.ndarray:
    """z-depth f32 [h, w] of an infinite wall at world z = wall_z, the
    camera looking roughly along +z."""
    fx, fy, cx, cy = K
    world_T_cam = np.linalg.inv(cam_T_world)
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    dirs_cam = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, np.float64)], -1)
    r = world_T_cam[:3, :3]
    o = world_T_cam[:3, 3]
    dirs_w = dirs_cam @ r.T
    # o_z + t d_z = wall_z; the depth along the camera's z is t (dirs_cam z = 1)
    dz = dirs_w[..., 2]
    t = np.where(np.abs(dz) > 1e-9, (wall_z - o[2]) / dz, 0.0)
    return np.where(t > 0, t, 0.0).astype(np.float32)


def render_sphere(w, h, K, cam_T_world, center, radius) -> np.ndarray:
    """z-depth f32 [h, w] of a sphere; 0 where the ray misses."""
    fx, fy, cx, cy = K
    world_T_cam = np.linalg.inv(cam_T_world)
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    dirs_cam = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, np.float64)], -1)
    norm = np.linalg.norm(dirs_cam, axis=-1, keepdims=True)
    r = world_T_cam[:3, :3]
    o = world_T_cam[:3, 3]
    d = (dirs_cam / norm) @ r.T
    oc = o - np.asarray(center, np.float64)
    b = 2 * (d @ oc)
    c = oc @ oc - radius * radius
    disc = b * b - 4 * c
    t = np.where(disc >= 0, (-b - np.sqrt(np.maximum(disc, 0))) / 2, 0.0)
    # the range back to z-depth
    depth = t / norm[..., 0]
    return np.where((disc >= 0) & (t > 0), depth, 0.0).astype(np.float32)


def checker_rgb(w, h, size=8) -> np.ndarray:
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    c = ((uu // size + vv // size) % 2).astype(np.float32)
    rgb = np.stack([c * 200 + 30, (1 - c) * 180 + 40, c * 90 + 80], -1)
    return rgb.astype(np.float32)


def make_orbit_frames(n_frames, w, h, K):
    """n_frames of (cam_T_world f32 [4, 4], rgb f32 [h, w, 3], depth f32
    [h, w] metres, ht, lt f32 [h, w]): the sphere and the back wall from a
    camera swinging on an arc, ht 0.9 on the sphere and 0.5 elsewhere."""
    frames = []
    rgb = checker_rgb(w, h)
    for i in range(n_frames):
        ang = 0.25 * np.sin(2 * np.pi * i / n_frames)
        eye = (np.sin(ang) * 1.9 + 0.013, -0.021 + 0.03 * np.sin(i * 0.4),
               -1.9 * np.cos(ang) + 1.0)
        pose = look_at(eye, (0.013, -0.021, 1.007))
        d_sphere = render_sphere(w, h, K, pose, center=(0.013, -0.021, 1.007), radius=0.413)
        d_wall = render_wall(w, h, K, pose, wall_z=2.213)
        depth = np.where(d_sphere > 0, d_sphere, d_wall).astype(np.float32)
        ht = (0.5 + 0.4 * (d_sphere > 0)).astype(np.float32)
        lt = (1.0 - ht).astype(np.float32)
        frames.append((pose.astype(np.float32), rgb, depth, ht, lt))
    return frames
