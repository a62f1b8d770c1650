"""Self-contained dense SLAM on the PyTorch port: track + fuse RGB-D frames
WITHOUT poses (counterpart of apps/dense_slam.py).

Runs the port's frame-to-model ICP tracker (systems/dense_slam.py) on a
pose-free dataset ({id}_depth.png, with {id}_rgb.png where present),
producing an estimated trajectory (replayable by apps.offline), a fused
volume checkpoint and a mesh; --evaluate scores the trajectory (ATE +
RPE) against a ground truth.

  python -m disinfect_slam_tpu_torch.apps.dense_slam --logdir DATA \\
      --config cam.yaml --out-traj traj_est.txt --mesh out.obj --save vol.npz

It runs on the CUDA device unless asked for another (--device cpu).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from ..config import TSDFConfig
from ..io.checkpoint import save_volume
from ..io.config_reader import get_depth_factor, get_intrinsics, load_yaml
from ..io.png_io import read_image
from ..ops.mesh import extract_mesh_chunked, merge_vertices, save_obj
from ..systems.dense_slam import SPLAT_IMPLS, DenseSLAM
from ..systems.imu import ImuPreintegrator
from ..systems.slam import save_matched_trajectory
from ..utils import trajectory_eval as te
from ..utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logdir", required=True)
    ap.add_argument("--config")
    ap.add_argument("--voxel", type=float, default=0.02)
    ap.add_argument("--trunc", type=float, default=0.06)
    ap.add_argument("--max-depth", type=float, default=4.0)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out-traj", help="write estimated trajectory here")
    ap.add_argument("--evaluate", metavar="GT",
                    help="score the estimated trajectory (ATE+RPE) against this "
                         "ground-truth file; 'auto' uses <logdir>/trajectory.txt")
    ap.add_argument("--mesh")
    ap.add_argument("--save", help="volume checkpoint (.npz)")
    ap.add_argument("--preset", choices=["full", "small"], default="full")
    ap.add_argument("--splat", choices=list(SPLAT_IMPLS), default="auto",
                    help="model-depth z-buffer: auto / pallas = the "
                         "splat_zbuf_blocks kernel on a CUDA device, xla = the "
                         "plain torch scatter (the same bits)")
    ap.add_argument("--loop-closure", action="store_true",
                    help="keyframe place recognition + ICP-verified loop "
                         "constraints + pose-graph relaxation "
                         "(systems/loop_closure.py); also enables "
                         "relocalization after tracking loss")
    ap.add_argument("--kf-every", type=int, default=10,
                    help="keyframe cadence (frames) for --loop-closure")
    ap.add_argument("--lc-min-gap", type=int, default=60,
                    help="minimum frame-id gap before a keyframe can "
                         "close a loop (recency guard)")
    ap.add_argument("--save-map", metavar="NPZ",
                    help="with --loop-closure: save the keyframe/map database")
    ap.add_argument("--load-map", metavar="NPZ",
                    help="with --loop-closure: preload a keyframe/map database "
                         "(localize against a prior session)")
    ap.add_argument("--imu", metavar="CSV",
                    help="IMU samples 't_ms,gx,gy,gz,ax,ay,az' (rad/s, m/s^2, "
                         "camera frame): gravity-aligns the world frame from the "
                         "initial static window, and, when the logdir has "
                         "frame_times.txt ('fid t_ms' rows), seeds each frame's "
                         "ICP with the gyro rotation prior")
    ap.add_argument("--imu-full", action="store_true",
                    help="with --imu: accel preintegration adds a translation "
                         "prior (systems/imu.py relative_motion) on top of the "
                         "gyro rotation")
    ap.add_argument("--device", default="cuda",
                    help="torch device; without CUDA the run stops unless this is cpu")
    return ap.parse_args(argv)


def evaluate(gt_path: str, poses: dict) -> dict:
    """ATE + RPE (delta 1) of the tracked frames' poses (cam_T_world by
    frame id, None for lost frames) against a ground-truth file."""
    ts_gt, gt = te.load_trajectory(gt_path)
    ok_ids = sorted(fid for fid, p in poses.items() if p is not None)
    est = np.stack([np.linalg.inv(poses[fid]) for fid in ok_ids])
    pairs = te.associate(ts_gt, np.array(ok_ids, np.float64), max_dt=0.5)
    ig = [i for i, _ in pairs]
    ie = [j for _, j in pairs]
    return {
        "pairs": len(pairs),
        "ate": {k: v for k, v in te.ate(gt[ig], est[ie]).items()
                if k in ("rmse", "mean", "median", "max", "n")},
        "rpe": te.rpe(gt[ig], est[ie], delta=1),
    }


def run(args) -> dict:
    """Track and fuse the dataset; returns the DenseSLAM object, the
    frame count, the loop's wall seconds, the resolved poses
    (cam_T_world by frame id, None where tracking was lost) and the ok
    flags, and with --evaluate the report, with --mesh the counts."""
    device = resolve_device(args.device)
    if args.config:
        y = load_yaml(args.config)
        intrinsics = get_intrinsics(y)
        depth_factor = get_depth_factor(y)
    else:
        intrinsics = (517.3, 516.5, 318.6, 255.3)
        depth_factor = 5000.0

    frames = sorted(glob.glob(os.path.join(args.logdir, "*_depth.png")),
                    key=lambda p: int(os.path.basename(p).split("_")[0]))
    if args.max_frames:
        frames = frames[: args.max_frames]
    if not frames:
        raise SystemExit(f"no *_depth.png in {args.logdir}")
    h, w = read_image(frames[0], unchanged=True).shape

    cfg = None
    if args.preset == "small":
        cfg = TSDFConfig(num_blocks_log2=12, max_candidates=8192, max_visible=4096,
                         max_new_per_round=2048, grid_log2=7)
    slam = DenseSLAM(
        intrinsics, h, w, voxel_size=args.voxel, truncation=args.trunc,
        max_depth=args.max_depth, cfg=cfg, splat_impl=args.splat,
        loop_closure=args.loop_closure, kf_every=args.kf_every,
        lc_kwargs=dict(min_gap_frames=args.lc_min_gap), device=device,
    )
    if args.load_map:
        slam.load_map(args.load_map)
        print(f"[slam] map database loaded: {slam.lc.count} keyframes")

    preint = None
    frame_time = {}
    if args.imu:
        preint = ImuPreintegrator()
        for row in np.loadtxt(args.imu, delimiter=",", ndmin=2):
            preint.add_raw(row[0], gyro=row[1:4], accel=row[4:7])
        preint.estimate_bias()
        if args.imu_full:
            # translation priors need the accel bias split consistent
            # with the gravity window (see estimate_accel_bias)
            preint.estimate_accel_bias()
        w0 = preint.gravity_aligned_pose()
        slam.set_initial_pose(w0)
        if preint.estimate_gravity() is None:
            print("[slam] imu: no gravity estimate (identity start)")
        else:
            tilt = np.degrees(np.arccos(np.clip(w0[2, 2], -1.0, 1.0)))
            print(f"[slam] gravity-aligned start (tilt {tilt:.1f} deg)")
        ft = os.path.join(args.logdir, "frame_times.txt")
        if os.path.exists(ft):
            with open(ft) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        frame_time[int(parts[0])] = float(parts[1])
            print(f"[slam] gyro priors from {len(frame_time)} frame times")

    poses = {}
    prev_t = None
    prev_wTc = None
    prev_wTc_t = None
    t0 = time.perf_counter()
    for i, dp in enumerate(frames):
        fid = int(os.path.basename(dp).split("_")[0])
        depth = read_image(dp, unchanged=True).astype(np.float32) / depth_factor
        rgb_path = dp.replace("_depth.png", "_rgb.png")
        rgb = (read_image(rgb_path).astype(np.float32) if os.path.exists(rgb_path)
               else np.zeros((h, w, 3), np.float32))
        gyro_prior = None
        trans_prior = None
        if preint is not None and fid in frame_time:
            t = frame_time[fid]
            if prev_t is not None:
                if args.imu_full:
                    # full inertial seed: the tracked attitude (on the host
                    # already) and a finite-differenced velocity
                    wTc = np.asarray(slam.world_T_cam, np.float64)
                    # velocity from the PREVIOUS interval: displacement
                    # prev_wTc -> wTc spans prev_wTc_t -> prev_t
                    v0 = ((wTc[:3, 3] - prev_wTc[:3, 3])
                          / max((prev_t - prev_wTc_t) * 1e-3, 1e-6)
                          if prev_wTc is not None else np.zeros(3))
                    r_rel, dp_w, _ = preint.relative_motion(prev_t, t, wTc[:3, :3], v0)
                    gyro_prior, trans_prior = r_rel, dp_w
                    prev_wTc, prev_wTc_t = wTc, prev_t
                else:
                    gyro_prior = preint.relative_rotation(prev_t, t)
            prev_t = t
        # pose/ok come back as device tensors; the trajectory is resolved
        # in bulk after the loop
        pose, ok = slam.process_frame(rgb, depth, gyro_prior=gyro_prior,
                                      trans_prior=trans_prior)
        poses[fid] = (pose, ok)
        if (i + 1) % 25 == 0:
            dt = time.perf_counter() - t0
            print(f"[slam] {i+1}/{len(frames)} frames ({(i+1)/dt:.1f} FPS), "
                  f"{int(slam.volume.num_active_blocks)} blocks, {slam.lost_count} lost")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    # the whole trajectory in one copy
    fids = list(poses)
    all_poses = torch.stack([p for p, _ok in poses.values()]).cpu().numpy()
    all_ok = torch.stack([ok for _p, ok in poses.values()]).cpu().numpy()
    ok_flags = {fid: bool(ok) for fid, ok in zip(fids, all_ok)}
    poses = {fid: (p if ok else None) for fid, p, ok in zip(fids, all_poses, all_ok)}
    print(f"[slam] done: {len(frames)} frames in {dt:.1f}s "
          f"({len(frames)/dt:.2f} FPS), lost {slam.lost_count}")
    result = {"slam": slam, "frames": len(frames), "seconds": dt, "ok": ok_flags,
              "poses": poses, "evaluation": None, "mesh": None}

    if args.loop_closure:
        print(f"[slam] loop closure: {slam.lc.count} keyframes, "
              f"{slam.lc.closures} loops closed")
        ok_ids = sorted(fid for fid, p in poses.items() if p is not None)
        if ok_ids and slam.lc.closures:
            # retro-correct the recorded trajectory with the optimized
            # keyframe poses (already-written fusion stays)
            corr = slam.correct_trajectory(np.asarray(ok_ids),
                                           np.stack([poses[f] for f in ok_ids]))
            for fid, c in zip(ok_ids, corr):
                poses[fid] = c
        if args.save_map:
            slam.save_map(args.save_map)
            print(f"[slam] map database -> {args.save_map}")

    if args.out_traj:
        n = save_matched_trajectory(args.out_traj, poses, sorted(poses))
        print(f"[slam] wrote {n} poses to {args.out_traj}")

    if args.evaluate:
        gt_path = (args.evaluate if args.evaluate != "auto"
                   else os.path.join(args.logdir, "trajectory.txt"))
        result["evaluation"] = evaluate(gt_path, poses)
        print(f"[slam] evaluation vs {gt_path}: {json.dumps(result['evaluation'])}")

    if args.mesh:
        tris = extract_mesh_chunked(slam.volume)
        verts, faces = merge_vertices(tris)
        save_obj(args.mesh, verts, faces)
        result["mesh"] = {"vertices": len(verts), "faces": len(faces)}
        print(f"[slam] mesh: {len(verts)} verts -> {args.mesh}")

    if args.save:
        save_volume(args.save, slam.volume)
        print(f"[slam] volume -> {args.save}")
    return result


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
