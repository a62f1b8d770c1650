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

With --online it writes disinfect_slam_tpu_torch/data/
orbit_vga_online_fingerprint.json instead: the JAX FusedOnlineStep (same
config, exact sampler, the shipped UNet in bfloat16) over the first 30
frames, fed the dataset's own u8 rgb and raw u16 depth PNGs (depth factor
5000), summarised the same way, plus the segmentation of frame 0 by
InferenceEngine for both shipped nets: float64 sums of the 640x360 ht and
lt maps and their pixel counts above 0.5.

chip_smoke.py holds the port's GPU runs against these files, because the
GPU host has no JAX.  Each takes minutes and several GB of host memory:

  python scripts/port_fingerprint.py [--online]
"""

import argparse
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
from disinfect_slam_tpu.io.png_io import read_image  # noqa: E402
from disinfect_slam_tpu.models import segmentation as seg  # noqa: E402
from disinfect_slam_tpu.ops import render_fast  # noqa: E402
from disinfect_slam_tpu.ops.gather import to_numpy_records  # noqa: E402
from disinfect_slam_tpu.systems.online_step import FusedOnlineStep  # noqa: E402
from disinfect_slam_tpu.systems.tsdf_grid import TSDFGrid  # noqa: E402
from disinfect_slam_tpu_torch.config import BENCH, BENCH_MAX_DEPTH  # noqa: E402
from disinfect_slam_tpu_torch.ops.gather import volume_fingerprint  # noqa: E402
from disinfect_slam_tpu_torch.ops.render_fast import render_fingerprint  # noqa: E402

DATASET = os.path.join(ROOT, "datasets", "orbit_vga")
DATA = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data")
OUT = os.path.join(DATA, "orbit_vga_bench_fingerprint.json")
OUT_ONLINE = os.path.join(DATA, "orbit_vga_online_fingerprint.json")
ONLINE_FRAMES = 30


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


def seg_fingerprint(ht, lt) -> dict:
    """Summary of one frame's 640x360 ht and lt maps."""
    return {"shape": list(ht.shape),
            "sum_ht": float(ht.astype(np.float64).sum()),
            "sum_lt": float(lt.astype(np.float64).sum()),
            "ht_above_half": int((ht > 0.5).sum()),
            "lt_above_half": int((lt > 0.5).sum())}


def online():
    cam = load_yaml(os.path.join(DATASET, "cam.yaml"))
    intrinsics = get_intrinsics(cam)
    depth_factor = get_depth_factor(cam)
    replay = LoggedReplay(DATASET, depth_factor)
    cfg = TSDFConfig(**dataclasses.replace(BENCH, sampler="gather").__dict__)
    frames = []
    for fid, pose in replay.entries[:ONLINE_FRAMES]:
        base = os.path.join(DATASET, str(fid))
        frames.append((read_image(base + "_rgb.png"),
                       read_image(base + "_depth.png", unchanged=True), pose))
    rgb0, depth0, _ = frames[0]
    assert rgb0.dtype == np.uint8 and depth0.dtype == np.uint16
    segs = {}
    for arch in ("unet", "fast"):
        eng = seg.InferenceEngine(seg.create_model(arch=arch), seg.load_default_params(arch))
        segs[arch] = seg_fingerprint(*eng.infer_one(rgb0))
        print(f"[fingerprint] seg {arch}: {segs[arch]}", flush=True)
    step = FusedOnlineStep(cfg, intrinsics, *depth0.shape, BENCH_MAX_DEPTH,
                           seg_model=seg.create_model(),
                           seg_params=seg.load_default_params("unet"),
                           depth_factor=depth_factor)
    t0 = time.perf_counter()
    for i, (rgb, depth, pose) in enumerate(frames):
        step.step(rgb, depth, pose)
        if (i + 1) % 10 == 0:
            step.block_until_ready()
            print(f"[fingerprint] online frame {i + 1}: {step.num_active_blocks()} "
                  f"blocks, {time.perf_counter() - t0:.0f} s", flush=True)
    vol = step.volume
    fp = volume_fingerprint({f: np.asarray(getattr(vol, f)) for f in (
        "entry_key", "entry_block", "oob_count", "tsdf", "rgbw", "prob")})
    grid = TSDFGrid(cfg.voxel_size, cfg.truncation, cfg=cfg)
    grid.volume = vol
    fp["records"] = int(to_numpy_records(grid.gather_valid()).shape[0])
    out = {
        "reference": "disinfect_slam_tpu FusedOnlineStep on CPU, sampler='gather', "
                     "shipped UNet (bfloat16)",
        "dataset": "datasets/orbit_vga",
        "frames": len(frames),
        "inputs": "u8 rgb, raw u16 depth",
        "depth_factor": depth_factor,
        "preset": "bench",
        "max_depth": BENCH_MAX_DEPTH,
        **fp,
        "seg_frame0": segs,
    }
    with open(OUT_ONLINE, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out, indent=1))


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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--online", action="store_true",
                    help="write the online step's fingerprint instead")
    if ap.parse_args().online:
        online()
    else:
        main()
