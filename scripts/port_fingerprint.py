#!/usr/bin/env python
"""Fingerprint of the JAX reference on the offline benchmark replay.

Replays all frames of datasets/orbit_vga through the JAX package on the
CPU with the exact gather sampler at the benchmark capacity config (the
PyTorch port's `bench` preset: 4 mm voxels, 24 mm truncation, 2^18-block
pool, 32k visible blocks, alloc_stride 4, alloc_every 3, max depth 4 m)
and writes a summary of the fused volume to
disinfect_slam_tpu_torch/data/orbit_vga_bench_fingerprint.json: active
blocks, oob count, the data.bin record count, a sha256 of the sorted
packed keys of the live blocks, and float64 sums of |tsdf|, weight and
prob over the live voxels.  Under "render" it adds a summary of two splat
renders of the fused volume (ops/render_fast.splat_render, op by op):
the frame-0 view at 640x480 and the offline app's final view (last pose,
640x360), both at max depth 4 m.

chip_smoke.py holds the port's GPU replay against this file, because the
GPU host has no JAX.  It takes minutes and several GB of host memory:

  python scripts/port_fingerprint.py
"""

import dataclasses
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from disinfect_slam_tpu.config import TSDFConfig  # noqa: E402
from disinfect_slam_tpu.core.geometry import (  # noqa: E402
    SE3, CameraIntrinsics, CameraParams,
)
from disinfect_slam_tpu.io.config_reader import (  # noqa: E402
    get_depth_factor, get_intrinsics, load_yaml,
)
from disinfect_slam_tpu.io.dataset import LoggedReplay  # noqa: E402
from disinfect_slam_tpu.ops import render_fast  # noqa: E402
from disinfect_slam_tpu.ops.gather import to_numpy_records  # noqa: E402
from disinfect_slam_tpu.systems.tsdf_grid import TSDFGrid  # noqa: E402
from disinfect_slam_tpu_torch.config import BENCH, BENCH_MAX_DEPTH  # noqa: E402
from disinfect_slam_tpu_torch.ops.gather import volume_fingerprint  # noqa: E402
from disinfect_slam_tpu_torch.ops.render_fast import render_fingerprint  # noqa: E402

DATASET = os.path.join(ROOT, "datasets", "orbit_vga")
OUT = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data",
                   "orbit_vga_bench_fingerprint.json")


# the views held against the port: (pose index, image height, width)
RENDER_VIEWS = {"frame0": (0, 480, 640), "app": (-1, 360, 640)}


def render_views(vol, intrinsics, poses) -> dict:
    """Fingerprints of the JAX splat render of each RENDER_VIEWS view."""
    out = {}
    for name, (i, hgt, wid) in RENDER_VIEWS.items():
        cam = CameraParams.create(CameraIntrinsics.create(*intrinsics), hgt, wid)
        pose = SE3.from_matrix(poses[i])
        res = render_fast.splat_render(vol, cam, pose, BENCH_MAX_DEPTH)
        vis, overflow = render_fast._surf_visible(
            vol, cam, pose, 1.25, render_fast.DEFAULT_SURF_CAP)
        out[name] = render_fingerprint(
            res.hit, res.depth, res.rgba, res.normal, res.surf_overflow,
            np.asarray(vis.count) + np.asarray(overflow))
        print(f"[fingerprint] render {name}: {out[name]}", flush=True)
    return out


def main():
    cam = load_yaml(os.path.join(DATASET, "cam.yaml"))
    intrinsics = get_intrinsics(cam)
    replay = LoggedReplay(DATASET, get_depth_factor(cam))
    cfg = TSDFConfig(**dataclasses.replace(BENCH, sampler="gather").__dict__)
    grid = TSDFGrid(cfg.voxel_size, cfg.truncation, cfg=cfg)
    t0 = time.perf_counter()
    n = 0
    poses = []
    for frame in replay:
        poses.append(frame.cam_T_world)
        grid.integrate(frame.rgb, frame.depth, frame.ht, frame.lt,
                       BENCH_MAX_DEPTH, intrinsics, frame.cam_T_world)
        n += 1
        if n % 10 == 0:
            grid.block_until_ready()
            print(f"[fingerprint] frame {n}: {grid.num_active_blocks()} blocks, "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    vol = grid.volume
    fp = volume_fingerprint({f: np.asarray(getattr(vol, f)) for f in (
        "entry_key", "entry_block", "oob_count", "tsdf", "rgbw", "prob")})
    fp["records"] = int(to_numpy_records(grid.gather_valid()).shape[0])
    out = {
        "reference": "disinfect_slam_tpu on CPU, sampler='gather'",
        "dataset": "datasets/orbit_vga",
        "frames": n,
        "preset": "bench",
        "max_depth": BENCH_MAX_DEPTH,
        **fp,
        "render": render_views(vol, intrinsics, poses),
    }
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
