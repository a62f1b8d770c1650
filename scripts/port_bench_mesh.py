#!/usr/bin/env python
"""Mesh export's wall clock on the PyTorch port (counterpart of
scripts/bench_mesh.py, with its configuration and sizes).

Fuses the bench-scale volume (30 frames of the checked-in orbit_vga
replay, or of the synthetic orbit, at 4 mm voxels; allocation on every
frame, as bench_mesh.py's step allocates), then times:
  1. extract_mesh_chunked with the float32 transfer
  2. extract_mesh_chunked with the q16 transfer
  3. the full OBJ (extract + merge_vertices + save_obj)
  4. the 2 m-bbox voxel query of the bridge's 5 Hz cadence
     (gather_voxels, its count read on the host; the reconstTimerCallback
     workload, ros_offline.cc:320-350)
The first extraction of each transfer is a warm-up; the second is timed.

    python scripts/port_bench_mesh.py [--device cpu]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from disinfect_slam_tpu_torch.apps.bench import load_replay_frames, stage_frames  # noqa: E402
from disinfect_slam_tpu_torch.config import BENCH, BENCH_MAX_DEPTH  # noqa: E402
from disinfect_slam_tpu_torch.core.geometry import CameraIntrinsics, CameraParams  # noqa: E402
from disinfect_slam_tpu_torch.core.state import TSDFVolume  # noqa: E402
from disinfect_slam_tpu_torch.io.orbit_scene import make_orbit_frames  # noqa: E402
from disinfect_slam_tpu_torch.ops.gather import BoundingCube, gather_voxels  # noqa: E402
from disinfect_slam_tpu_torch.ops.integrate import integrate  # noqa: E402
from disinfect_slam_tpu_torch.ops.mesh import (  # noqa: E402
    extract_mesh_chunked, merge_vertices, save_obj,
)
from disinfect_slam_tpu_torch.utils.device import resolve_device  # noqa: E402
from disinfect_slam_tpu_torch.utils.timing import card_name_and_power  # noqa: E402

W, H = 640, 480
K = (525.1, 525.3, 319.6, 239.7)
FRAMES = 30
QUERIES = 10
OBJ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".bench_mesh.obj")


def run(device, n_frames: int = FRAMES, w: int = W, h: int = H, K=K, cfg=BENCH,
        obj_path: str = OBJ) -> dict:
    """Fuse n_frames at w x h into a cfg volume and time the four exports;
    prints a line for each and returns their times in seconds."""
    dev = resolve_device(device)
    print(f"device {dev} ({card_name_and_power() if dev.type == 'cuda' else 'cpu'})",
          flush=True)
    cam = CameraParams.create(CameraIntrinsics.create(*K), h, w)
    frames = load_replay_frames(n_frames, w, h) or make_orbit_frames(n_frames, w, h, K)
    vol = TSDFVolume.create(cfg, dev)
    print(f"populating volume ({n_frames} frames)...", flush=True)
    for fr, pose in stage_frames(frames, dev):
        vol = integrate(vol, fr, cam, pose, BENCH_MAX_DEPTH)
    print(f"active blocks: {int(vol.num_active_blocks)}", flush=True)
    out = {}

    # 1+2: chunked extraction, both transfers (the bridge reuses warm state)
    for mode in ("f32", "q16"):
        extract_mesh_chunked(vol, transfer=mode)
        t0 = time.perf_counter()
        tris = extract_mesh_chunked(vol, transfer=mode)
        out[mode] = dt = time.perf_counter() - t0
        print(f"extract_mesh_chunked[{mode}]: {dt:.2f} s ({tris.shape[0]} tris)", flush=True)

    # 3: the full OBJ artefact (extract + weld + write)
    t0 = time.perf_counter()
    tris = extract_mesh_chunked(vol, transfer="q16")
    verts, faces = merge_vertices(tris, tol=cfg.voxel_size / 16.0)
    save_obj(obj_path, verts, faces)
    out["obj"] = dt = time.perf_counter() - t0
    size_mb = os.path.getsize(obj_path) / 1e6
    os.remove(obj_path)
    print(f"full-volume OBJ: {dt:.2f} s ({len(verts)} verts, {len(faces)} faces, "
          f"{size_mb:.1f} MB)", flush=True)

    # 4: the bridge's cadence, a 2 m box 1.5 m ahead of the first camera (a
    # box centred on the camera, which orbits outside the geometry, holds
    # no voxel)
    w2c = np.linalg.inv(frames[0][0])
    ctr = w2c[:3, 3] + w2c[:3, 2] * 1.5
    bbox = BoundingCube(ctr[0] - 1, ctr[0] + 1, ctr[1] - 1, ctr[1] + 1, ctr[2] - 1, ctr[2] + 1)
    gather_voxels(vol, bbox)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(QUERIES):
        n = int(gather_voxels(vol, bbox).count)  # the bridge reads the count
    out["query"] = dt = (time.perf_counter() - t0) / QUERIES
    print(f"2 m-bbox query: {dt * 1e3:.1f} ms ({n} voxels) -> "
          f"{'OK for 5 Hz' if dt < 0.2 else 'TOO SLOW for 5 Hz'}", flush=True)
    out["query_voxels"] = n
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
