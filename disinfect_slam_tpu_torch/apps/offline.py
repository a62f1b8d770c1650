"""Offline TSDF replay on the PyTorch port (counterpart of apps/offline.py;
reference examples/tsdf/offline.cc).

Replays a logged dataset (trajectory.txt + {id}_rgb/_depth[/_ht/_no_ht]
PNGs) through TSDFGrid, reports the integrate time per frame, can dump
the fused volume as VoxelSpatialTSDF records (data.bin) and render the
final view to PNGs.

Usage:
  python -m disinfect_slam_tpu_torch.apps.offline --logdir datasets/orbit_vga \
      --config datasets/orbit_vga/cam.yaml --preset bench --save data.bin \
      --render-dir out --renderer auto
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..config import BENCH, BENCH_MAX_DEPTH, TSDFConfig
from ..io.config_reader import (
    get_depth_factor,
    get_extrinsics,
    get_intrinsics,
    load_yaml,
)
from ..io.dataset import LoggedReplay
from ..ops.gather import dump_spatial_tsdf
from ..systems.tsdf_grid import RENDERERS, TSDFGrid
from ..utils.timing import StageTimer
from ..viz.headless import render_to_png

# (voxel m, truncation m, max depth m) when the flags leave them unset
_FULL_DEFAULTS = (0.01, 0.06, 10.0)
_BENCH_DEFAULTS = (BENCH.voxel_size, BENCH.truncation, BENCH_MAX_DEPTH)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logdir", required=True, help="dataset directory")
    ap.add_argument("--config", help="camera YAML (Camera.fx..., depthmap_factor)")
    ap.add_argument("--voxel", type=float, help="voxel size in metres")
    ap.add_argument("--trunc", type=float, help="truncation in metres")
    ap.add_argument("--max-depth", type=float, help="depth cut-off in metres")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--save", help="dump VoxelSpatialTSDF binary here")
    ap.add_argument(
        "--sampler", choices=["auto", "gather", "pallas", "pallas_fused"],
        default="auto",
        help="auto / pallas_fused: the fused sample+fusion kernel; gather / "
             "pallas: the sample kernel followed by torch fusion math",
    )
    ap.add_argument(
        "--preset", choices=["full", "small", "bench"], default="full",
        help="volume capacity preset (small: quick CPU runs; bench: the "
             "benchmark's 2^18-block, 4 mm configuration)",
    )
    ap.add_argument("--render-dir", help="write the final view's PNGs here")
    ap.add_argument(
        "--renderer", choices=list(RENDERERS), default="auto",
        help="raycast: the parity ray marcher; splat / splat_pallas: the "
             "splat renderer (its CUDA kernels on a CUDA device); auto: "
             "splat on a CUDA device, raycast elsewhere",
    )
    ap.add_argument(
        "--device", default="cuda" if torch.cuda.is_available() else "cpu",
        help="torch device for the volume and the kernels",
    )
    return ap.parse_args(argv)


def make_config(args) -> tuple[TSDFConfig, float, float, float]:
    """(config, voxel size, truncation, max depth) for the parsed flags."""
    voxel, trunc, max_depth = (
        _BENCH_DEFAULTS if args.preset == "bench" else _FULL_DEFAULTS
    )
    voxel = args.voxel if args.voxel is not None else voxel
    trunc = args.trunc if args.trunc is not None else trunc
    max_depth = args.max_depth if args.max_depth is not None else max_depth
    if args.preset == "bench":
        cfg = BENCH
    elif args.preset == "small":
        cfg = TSDFConfig(
            num_blocks_log2=12,
            max_candidates=8192,
            max_visible=4096,
            max_new_per_round=2048,
            grid_log2=7,
        )
    elif voxel < 0.008:
        # sub-8mm voxels at VGA put ~30k blocks in view: scale the default
        # capacities up, as the JAX app does
        cfg = TSDFConfig(
            num_blocks_log2=17,
            max_candidates=32768,
            max_visible=32768,
            max_new_per_round=8192,
        )
    else:
        cfg = TSDFConfig()
    cfg = dataclasses.replace(cfg, sampler=args.sampler)
    return cfg, voxel, trunc, max_depth


def run(args) -> dict:
    """Replay the dataset; returns the grid, per-frame integrate seconds,
    with --save the number of records written and with --render-dir the
    PNG paths and the render time."""
    if args.config:
        cam_yaml = load_yaml(args.config)
        intrinsics = get_intrinsics(cam_yaml)
        depth_factor = get_depth_factor(cam_yaml)
        extrinsics = get_extrinsics(cam_yaml)
    else:
        # TUM freiburg1 defaults (configs/tum_rgbd_1.yaml)
        intrinsics = (517.3, 516.5, 318.6, 255.3)
        depth_factor = 5000.0
        extrinsics = np.eye(4, dtype=np.float32)
    replay = LoggedReplay(args.logdir, depth_factor, extrinsics)
    print(f"[offline] {len(replay)} frames")

    cfg, voxel, trunc, max_depth = make_config(args)
    grid = TSDFGrid(voxel, trunc, cfg=cfg, device=args.device)
    timer = StageTimer(grid.device)
    n = 0
    last_pose = np.eye(4, dtype=np.float32)
    for frame in replay:
        if n == 0:
            fh, fw = frame.depth.shape[:2]
            # cx/cy near the image centre is how the intrinsics and the
            # dataset agree on resolution; a big mismatch means a wrong
            # (or missing) --config
            if (abs(intrinsics[2] - fw / 2) > fw / 4
                    or abs(intrinsics[3] - fh / 2) > fh / 4):
                print(f"[offline] WARNING: intrinsics (cx={intrinsics[2]:.1f}, "
                      f"cy={intrinsics[3]:.1f}) look wrong for {fw}x{fh} frames "
                      "-- pass --config with the dataset's camera YAML")
        with timer.span("integrate"):
            grid.integrate(frame.rgb, frame.depth, frame.ht, frame.lt,
                           max_depth, intrinsics, frame.cam_T_world)
        last_pose = frame.cam_T_world
        n += 1
        if n % 25 == 0:
            print(f"[offline] frame {n}: integrate "
                  f"{timer.mean_ms('integrate'):.2f} ms/frame, "
                  f"{grid.num_active_blocks()} active blocks")
        if args.max_frames and n >= args.max_frames:
            break
    grid.block_until_ready()
    ms = timer.mean_ms("integrate")
    print(f"[offline] done: {n} frames on {grid.device}, integrate "
          f"{ms:.3f} ms/frame, {grid.num_active_blocks()} blocks")
    result = {"grid": grid, "frames": n,
              "integrate_s": list(timer.samples["integrate"]), "records": None,
              "render_paths": None, "render_ms": None}
    if args.save:
        result["records"] = dump_spatial_tsdf(grid.gather_valid(), args.save)
        print(f"[offline] saved {result['records']} voxels to {args.save}")
    if args.render_dir:
        # the final view at 640x360 from the last pose, as apps/offline.py
        with timer.span("render"):
            paths = render_to_png(grid, args.render_dir, last_pose,
                                  (intrinsics, 360, 640), max_depth=max_depth,
                                  prefix="final", renderer=args.renderer)
        result["render_paths"] = paths
        result["render_ms"] = timer.mean_ms("render")
        print(f"[offline] rendered {paths} ({result['render_ms']:.1f} ms, "
              f"renderer {args.renderer})")
    return result


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
