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

With --export it writes disinfect_slam_tpu_torch/data/
orbit_vga_export_fingerprint.json instead, the export slice over the same
60-frame replay volume (ops/mesh.py's mesh_fingerprint and
indexed_mesh_fingerprint, gather.py's volume_fingerprint): (a)
extract_mesh_chunked, f32 and q16; (b) ReconstructionBridge.query_mesh on
a 2 m BoundingCube centred 1.5 m ahead of the frame-0 camera; (c) the replay's dump
through volume_from_spatial_records, its rebuilt config and block count,
and the mesh of that volume; (d) the replay with backend="hash" and
alloc_dedup="sort".

With --slam it writes disinfect_slam_tpu_torch/data/
orbit_vga_slam_fingerprint.json instead: the JAX DenseSLAM (the pose-free
tracker, splat_impl="xla", the exact gather sampler) over all 60 frames
as apps/dense_slam.py runs them with --loop-closure at its defaults (2 cm
voxels, 6 cm truncation, 4 m, the default TSDFConfig, keyframes every 10
frames, a 60-frame loop gap), fed the dataset's u8 rgb as float32 and its
u16 depth over the depth factor: the per-frame cam_T_world and ok flags,
the lost, keyframe and closure counts, ATE and RPE against the dataset's
trajectory.txt, and the final volume's volume_fingerprint.  With
--slam --track-scale 2 it runs the same tracker at track_res_scale=2 (ICP
and the model depth at 320x240) and writes
orbit_vga_slam_s2_fingerprint.json.

With --no-semantics it writes disinfect_slam_tpu_torch/data/
orbit_vga_bench_noseg_fingerprint.json instead: the same replay with ht
and lt left out (the fusion takes ones), as the HTTP service fuses POSTed
frames in disinf mode (it drops their ht / lt), the volume's summary
alone.

chip_smoke.py holds the port's GPU runs against these files, because the
GPU host has no JAX.  Each takes minutes and several GB of host memory:

  python scripts/port_fingerprint.py [--online | --export | --slam [--track-scale 2] |
                                      --no-semantics]
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
OUT_EXPORT = os.path.join(DATA, "orbit_vga_export_fingerprint.json")
OUT_SLAM = os.path.join(DATA, "orbit_vga_slam_fingerprint.json")
OUT_SLAM_S2 = os.path.join(DATA, "orbit_vga_slam_s2_fingerprint.json")
OUT_NOSEG = os.path.join(DATA, "orbit_vga_bench_noseg_fingerprint.json")
# apps/dense_slam.py's defaults: voxel, truncation, max depth (m), keyframe
# cadence and loop gap (frames)
SLAM_VOXEL, SLAM_TRUNC, SLAM_MAX_DEPTH, SLAM_KF_EVERY, SLAM_LC_MIN_GAP = (
    0.02, 0.06, 4.0, 10, 60)
# the bridge query's cube: 2 m on a side, centred BRIDGE_AHEAD_M along the
# frame-0 camera's view axis (the camera stands 1.5 m before the nearest
# surface, so a cube centred on the camera itself holds none)
BRIDGE_HALF_M, BRIDGE_AHEAD_M = 1.0, 1.5
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


def replay_volume(cfg):
    """The JAX TSDFGrid after every frame of the replay, and the poses."""
    cam = load_yaml(os.path.join(DATASET, "cam.yaml"))
    intrinsics = get_intrinsics(cam)
    grid = TSDFGrid(cfg.voxel_size, cfg.truncation, cfg=cfg)
    poses = []
    t0 = time.perf_counter()
    for n, frame in enumerate(LoggedReplay(DATASET, get_depth_factor(cam)), start=1):
        poses.append(frame.cam_T_world)
        grid.integrate(frame.rgb, frame.depth, frame.ht, frame.lt,
                       BENCH_MAX_DEPTH, intrinsics, frame.cam_T_world)
        if n % 10 == 0:
            grid.block_until_ready()
            print(f"[fingerprint] {cfg.backend} frame {n}: {grid.num_active_blocks()} "
                  f"blocks, {time.perf_counter() - t0:.0f} s", flush=True)
    return grid, poses


def mesh_of(vol, transfer="f32") -> dict:
    from disinfect_slam_tpu.ops.mesh import extract_mesh_chunked
    from disinfect_slam_tpu_torch.ops.mesh import counting_clips, mesh_fingerprint

    t0 = time.perf_counter()
    with counting_clips("disinfect_slam_tpu.ops.mesh") as clipped:
        tris = extract_mesh_chunked(vol, transfer=transfer)
    fp = mesh_fingerprint(tris, clipped[0])
    print(f"[fingerprint] mesh {transfer}: {fp} ({time.perf_counter() - t0:.0f} s)",
          flush=True)
    return fp


def export():
    from types import SimpleNamespace

    from disinfect_slam_tpu.ops.gather import BoundingCube, volume_from_spatial_records
    from disinfect_slam_tpu.systems.bridge import ReconstructionBridge
    from disinfect_slam_tpu_torch.ops.mesh import indexed_mesh_fingerprint

    cfg = TSDFConfig(**dataclasses.replace(BENCH, sampler="gather").__dict__)
    grid, poses = replay_volume(cfg)
    out = {"reference": "disinfect_slam_tpu on CPU, sampler='gather'",
           "dataset": "datasets/orbit_vga", "frames": len(poses), "preset": "bench",
           "max_depth": BENCH_MAX_DEPTH}
    # (a) the replay volume's mesh
    out["mesh"] = {t: mesh_of(grid.volume, t) for t in ("f32", "q16")}
    # (b) the bridge's 2 m query before the frame-0 camera
    world_T_cam = np.linalg.inv(np.asarray(poses[0], np.float64))
    c = world_T_cam[:3, 3] + BRIDGE_AHEAD_M * world_T_cam[:3, 2]
    h = BRIDGE_HALF_M
    cube = BoundingCube(c[0] - h, c[0] + h, c[1] - h, c[1] + h, c[2] - h, c[2] + h)
    bridge = ReconstructionBridge(SimpleNamespace(tsdf=SimpleNamespace(tsdf=grid)), cube)
    out["bridge"] = {"cube": [float(x) for x in cube],
                     **indexed_mesh_fingerprint(*bridge.query_mesh())}
    print(f"[fingerprint] bridge: {out['bridge']}", flush=True)
    # (c) the dump, rebuilt by the loader, and its mesh
    rec = to_numpy_records(grid.gather_valid())
    del grid
    t0 = time.perf_counter()
    vol = volume_from_spatial_records(rec)
    load_s = time.perf_counter() - t0
    out["dump"] = {"records": int(rec.shape[0]),
                   "config": dataclasses.asdict(vol.cfg),
                   "active_blocks": int(np.asarray(vol.num_active_blocks)),
                   "load_s_on_cpu": load_s,
                   "mesh": mesh_of(vol)}
    del vol, rec
    # (d) the hash-backend replay
    hcfg = dataclasses.replace(cfg, backend="hash", alloc_dedup="sort")
    hgrid, _ = replay_volume(hcfg)
    vol = hgrid.volume
    fp = volume_fingerprint({f: np.asarray(getattr(vol, f)) for f in (
        "entry_key", "entry_block", "oob_count", "tsdf", "rgbw", "prob")})
    fp["records"] = int(to_numpy_records(hgrid.gather_valid()).shape[0])
    out["hash_replay"] = {"backend": "hash", "alloc_dedup": "sort", **fp}
    with open(OUT_EXPORT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out, indent=1))


def slam(track_scale: int = 1):
    from disinfect_slam_tpu.systems.dense_slam import DenseSLAM
    from disinfect_slam_tpu.utils import trajectory_eval as te

    cam = load_yaml(os.path.join(DATASET, "cam.yaml"))
    intrinsics = get_intrinsics(cam)
    depth_factor = get_depth_factor(cam)
    fids = [fid for fid, _ in LoggedReplay(DATASET, depth_factor).entries]
    base = os.path.join(DATASET, str(fids[0]))
    h, w = read_image(base + "_depth.png", unchanged=True).shape
    cfg = TSDFConfig(voxel_size=SLAM_VOXEL, truncation=SLAM_TRUNC, sampler="gather")
    dslam = DenseSLAM(intrinsics, h, w, voxel_size=SLAM_VOXEL, truncation=SLAM_TRUNC,
                      max_depth=SLAM_MAX_DEPTH, cfg=cfg, splat_impl="xla",
                      loop_closure=True, kf_every=SLAM_KF_EVERY,
                      lc_kwargs=dict(min_gap_frames=SLAM_LC_MIN_GAP),
                      track_res_scale=track_scale)
    poses, oks = [], []
    t0 = time.perf_counter()
    for n, fid in enumerate(fids, start=1):
        base = os.path.join(DATASET, str(fid))
        depth = read_image(base + "_depth.png", unchanged=True).astype(np.float32) / depth_factor
        rgb = read_image(base + "_rgb.png").astype(np.float32)
        pose, ok = dslam.process_frame(rgb, depth)
        poses.append(np.asarray(pose, np.float32))
        oks.append(bool(ok))
        if n % 10 == 0:
            print(f"[fingerprint] slam frame {n}: ok {sum(oks)}, "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    lc = dslam.lc
    if lc.closures:
        raise AssertionError("a loop closed: the fingerprint would need the corrected "
                             "trajectory")
    ts_gt, gt = te.load_trajectory(os.path.join(DATASET, "trajectory.txt"))
    ok_ids = [fid for fid, ok in zip(fids, oks) if ok]
    est = np.stack([np.linalg.inv(p) for p, ok in zip(poses, oks) if ok])
    pairs = te.associate(ts_gt, np.array(ok_ids, np.float64), max_dt=0.5)
    ig = [i for i, _ in pairs]
    ie = [j for _, j in pairs]
    ate = te.ate(gt[ig], est[ie])
    vol = dslam.volume
    out = {
        "reference": "disinfect_slam_tpu DenseSLAM on CPU, splat_impl='xla', "
                     "sampler='gather', loop closure on",
        "dataset": "datasets/orbit_vga",
        "frames": len(fids),
        "voxel": SLAM_VOXEL, "trunc": SLAM_TRUNC, "max_depth": SLAM_MAX_DEPTH,
        "kf_every": SLAM_KF_EVERY, "lc_min_gap": SLAM_LC_MIN_GAP,
        **({"track_res_scale": track_scale} if track_scale != 1 else {}),
        "frame_ids": fids,
        "ok": oks,
        "cam_T_world": [p.tolist() for p in poses],
        "lost": dslam.lost_count,
        "keyframes": lc.count,
        "closures": lc.closures,
        "ate": {k: float(ate[k]) for k in ("rmse", "mean", "max")},
        "rpe": te.rpe(gt[ig], est[ie], delta=1),
        "volume": volume_fingerprint({f: np.asarray(getattr(vol, f)) for f in (
            "entry_key", "entry_block", "oob_count", "tsdf", "rgbw", "prob")}),
    }
    with open(OUT_SLAM if track_scale == 1 else OUT_SLAM_S2, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items() if k != "cam_T_world"}, indent=1))


def main(semantics: bool = True):
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
        ht, lt = (frame.ht, frame.lt) if semantics else (None, None)
        grid.integrate(frame.rgb, frame.depth, ht, lt, BENCH_MAX_DEPTH, intrinsics,
                       frame.cam_T_world)
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
    }
    if semantics:
        out["render"] = render_views(vol, intrinsics, poses)
    else:
        out["semantics"] = "none: ht = lt = 1"
    with open(OUT if semantics else OUT_NOSEG, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--online", action="store_true",
                       help="write the online step's fingerprint instead")
    which.add_argument("--export", action="store_true",
                       help="write the export slice's fingerprint instead")
    which.add_argument("--slam", action="store_true",
                       help="write the pose-free dense SLAM's fingerprint instead")
    which.add_argument("--no-semantics", action="store_true",
                       help="write the replay's fingerprint with ht = lt = 1 instead")
    ap.add_argument("--track-scale", type=int, choices=(1, 2), default=1,
                    help="with --slam: DenseSLAM's track_res_scale (2 writes "
                         "orbit_vga_slam_s2_fingerprint.json)")
    args = ap.parse_args()
    if args.online:
        online()
    elif args.export:
        export()
    elif args.slam:
        slam(args.track_scale)
    else:
        main(semantics=not args.no_semantics)
