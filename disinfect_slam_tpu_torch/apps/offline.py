"""Offline TSDF replay on the PyTorch port (counterpart of apps/offline.py;
reference examples/tsdf/offline.cc).

Replays a logged dataset (trajectory.txt + {id}_rgb/_depth[/_ht/_no_ht]
PNGs, or a TUM RGB-D sequence with --tum) through TSDFGrid, decoding
--prefetch frames ahead, reports the integrate time per frame, can dump
the fused volume as VoxelSpatialTSDF records (data.bin), mesh it (OBJ)
and render the final view to PNGs.  --auto-recenter moves the dense
window after the camera; --grid-log2 widens it; --spill keeps the blocks
the window leaves in host memory and --page-radius pages them under pool
pressure.  --debug validates the volume after every frame; --profile
writes a torch.profiler trace of the replay.  --devices N shards the
volume by block ownership over N devices (parallel/sharding.py: the first
N CUDA devices, or N CPU shards with --device cpu), prints the per-shard
table and with --save-dist writes the elastic checkpoint, restorable onto
any shard count.

Usage:
  python -m disinfect_slam_tpu_torch.apps.offline --logdir datasets/orbit_vga \
      --config datasets/orbit_vga/cam.yaml --preset bench --save data.bin \
      --mesh out.obj --render-dir out --renderer auto

It runs on the CUDA device unless asked for another (--device cpu).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os
import sys
import time

import numpy as np
import torch

from ..config import BENCH, BENCH_MAX_DEPTH, TSDFConfig
from ..io.config_reader import (
    get_depth_factor,
    get_extrinsics,
    get_intrinsics,
    load_yaml,
)
from ..io.dataset import LoggedReplay, PrefetchReplay, TUMReplay
from ..ops.gather import dump_spatial_tsdf
from ..ops.integrate import FrameInput
from ..ops.mesh import extract_mesh_chunked, merge_vertices, save_obj
from ..parallel.sharding import DistributedTSDF, make_mesh, save_distributed
from ..systems.tsdf_grid import RENDERERS, TSDFGrid
from ..utils.device import resolve_device
from ..utils.timing import StageTimer
from ..utils.validate import validate_volume
from ..viz.headless import render_to_png

# (voxel m, truncation m, max depth m) when the flags leave them unset
_FULL_DEFAULTS = (0.01, 0.06, 10.0)
_BENCH_DEFAULTS = (BENCH.voxel_size, BENCH.truncation, BENCH_MAX_DEPTH)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="The JAX app's --scatter-window is not taken: it bounds an XLA "
               "scatter operand on the TPU, and fuse_rows writes the pool in place.")
    ap.add_argument("--logdir", required=True, help="dataset directory")
    ap.add_argument("--config", help="camera YAML (Camera.fx..., depthmap_factor)")
    ap.add_argument("--tum", action="store_true", help="TUM RGB-D layout")
    ap.add_argument("--voxel", type=float, help="voxel size in metres")
    ap.add_argument("--trunc", type=float, help="truncation in metres")
    ap.add_argument("--max-depth", type=float, help="depth cut-off in metres")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--save", help="dump VoxelSpatialTSDF binary here")
    ap.add_argument("--mesh", help="extract the mesh and save it here as OBJ")
    ap.add_argument("--mesh-q16", action="store_true",
                    help="16-bit fixed-point mesh transfer (half the bytes, at most "
                         "1/32 voxel of error; ops/mesh.py extract_mesh_chunked)")
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
    ap.add_argument("--backend", choices=["dense", "hash"], default="dense",
                    help="spatial index: the dense window, or the reference's "
                         "coordinate-unbounded hash (with the sort dedup)")
    ap.add_argument("--grid-log2", type=int, default=0, metavar="L",
                    help="dense backend: 2^L blocks of coverage a side (the window "
                         "spans 2^L * 8 * voxel metres); 0 = the preset's")
    ap.add_argument("--auto-recenter", action="store_true",
                    help="dense backend: move the coverage window after the camera "
                         "when it nears the window's edge (TSDFGrid.maybe_recenter)")
    ap.add_argument("--spill", action="store_true",
                    help="keep the blocks the window leaves (--auto-recenter) or paging "
                         "evicts (--page-radius) in host memory and restore them on "
                         "return (systems/block_streaming.py); --save appends them")
    ap.add_argument("--page-radius", type=float, default=0.0, metavar="M",
                    help="with --spill: every 10 frames, evict the blocks farther "
                         "than M metres from the camera when the pool nears "
                         "exhaustion and restore stored blocks within M "
                         "(TSDFGrid.maybe_page)")
    ap.add_argument("--prefetch", type=int, default=4, metavar="N",
                    help="decode N frames ahead of the device (0: read each frame "
                         "when it is fused, as the reference does)")
    ap.add_argument("--debug", action="store_true",
                    help="debug logging and the volume's invariants validated after "
                         "every frame (utils/validate.py)")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler trace of the replay to DIR/trace.json")
    ap.add_argument("--devices", type=int, default=0, metavar="N",
                    help="shard the volume over N devices (DistributedTSDF block-ownership "
                         "sharding): the first N CUDA devices, or N CPU shards with "
                         "--device cpu; --save writes every shard's records")
    ap.add_argument("--save-dist", metavar="NPZ",
                    help="with --devices: elastic sharded checkpoint, restorable onto "
                         "ANY shard count (parallel.sharding.load_distributed)")
    ap.add_argument("--render-dir", help="write the final view's PNGs here")
    ap.add_argument(
        "--renderer", choices=list(RENDERERS), default="auto",
        help="raycast: the parity ray marcher; splat / splat_pallas: the "
             "splat renderer (its CUDA kernels on a CUDA device); auto: "
             "splat on a CUDA device, raycast elsewhere",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device for the volume and the kernels; without CUDA "
             "the run stops unless this is cpu",
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
    if args.grid_log2:
        cfg = dataclasses.replace(cfg, grid_log2=args.grid_log2)
    if args.backend == "hash":
        cfg = dataclasses.replace(cfg, backend="hash", alloc_dedup="sort")
    return cfg, voxel, trunc, max_depth


def _replay(args, replay, grid, timer, intrinsics, max_depth, moves, pages):
    """The frame loop of run(): returns (frames, last pose)."""
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
        paging = args.spill and args.page_radius > 0
        if args.auto_recenter or paging:
            cam_pos = np.linalg.inv(np.asarray(frame.cam_T_world, np.float64))[:3, 3]
            if args.auto_recenter and grid.maybe_recenter(cam_pos, max_depth=max_depth):
                moves.append(n)
                print(f"[offline] recentered coverage window at frame {n}")
            if paging and n % 10 == 0:
                r, e = grid.maybe_page(cam_pos, radius_m=args.page_radius)
                if r or e:
                    pages.append((n, r, e))
                    print(f"[offline] paged at frame {n}: restored {r}, evicted {e}")
        with timer.span("integrate"):
            grid.integrate(frame.rgb, frame.depth, frame.ht, frame.lt,
                           max_depth, intrinsics, frame.cam_T_world)
        last_pose = frame.cam_T_world
        n += 1
        if args.debug:
            with timer.span("validate"):
                validate_volume(grid.snapshot())
        if n % 25 == 0:
            print(f"[offline] frame {n}: integrate "
                  f"{timer.mean_ms('integrate'):.2f} ms/frame, "
                  f"{grid.num_active_blocks()} active blocks")
        if args.max_frames and n >= args.max_frames:
            break
    grid.block_until_ready()
    return n, last_pose


def run(args) -> dict:
    """Replay the dataset; returns the grid, frames, per-frame integrate
    seconds, the frames at which the window moved, the pages (frame,
    restored, evicted), with --debug the frames validated, with --save
    the number of records written (the host store's appended after the
    device's), with --mesh the vertex and face counts and the mesh time,
    and with --render-dir the PNG paths and the render time."""
    device = resolve_device(args.device)
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
    if args.tum:
        replay = TUMReplay(args.logdir, depth_factor)
    else:
        replay = LoggedReplay(args.logdir, depth_factor, extrinsics)
    print(f"[offline] {len(replay)} frames")
    if args.prefetch > 0:
        # decode ahead of the device (the reference reads inside its
        # render loop, offline.cc:157-160)
        replay = PrefetchReplay(replay, depth=args.prefetch)

    cfg, voxel, trunc, max_depth = make_config(args)
    if args.devices:
        return _run_distributed(args, replay, intrinsics, cfg, voxel, trunc, max_depth,
                                device)
    grid = TSDFGrid(voxel, trunc, cfg=cfg, device=device, host_spill=args.spill)
    timer = StageTimer(grid.device)
    moves, pages = [], []
    # --debug: the package's DEBUG lines (TSDFGrid.integrate's block
    # counts) for this run only
    pkg_log = logging.getLogger("disinfect_slam_tpu_torch")
    log_level = pkg_log.level
    if args.debug:
        pkg_log.setLevel(logging.DEBUG)
    prof = contextlib.nullcontext()
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if grid.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    try:
        with prof:
            n, last_pose = _replay(args, replay, grid, timer, intrinsics, max_depth, moves,
                                   pages)
    finally:
        pkg_log.setLevel(log_level)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(f"[offline] profiler trace written to {args.profile}/trace.json")
    ms = timer.mean_ms("integrate")
    print(f"[offline] done: {n} frames on {grid.device}, integrate "
          f"{ms:.3f} ms/frame, {grid.num_active_blocks()} blocks")
    if args.debug:
        print(f"[offline] volume invariants OK every frame "
              f"(validate {timer.mean_ms('validate'):.1f} ms/frame)")
    store = grid.spill_store
    result = {"grid": grid, "frames": n,
              "integrate_s": list(timer.samples["integrate"]), "recenter_frames": moves,
              "pages": pages, "validated": len(timer.samples["validate"]),
              "records": None, "spilled_records": 0, "mesh": None, "render_paths": None,
              "render_ms": None}
    if args.save:
        result["records"] = dump_spatial_tsdf(grid.gather_valid(), args.save)
        print(f"[offline] saved {result['records']} voxels to {args.save}")
        if store is not None and len(store):
            # the store's blocks live in host memory, not in the volume:
            # append their records so that the dump covers the whole map
            rec = store.spatial_records(grid.cfg)
            with open(args.save, "ab") as f:
                rec.astype("<f4").tofile(f)
            result["spilled_records"] = rec.shape[0]
            print(f"[offline] appended {rec.shape[0]} spilled voxels "
                  f"({len(store)} blocks from the host store)")
    if args.mesh and store is not None and len(store):
        print(f"[offline] WARNING: --mesh covers the on-device window only; "
              f"{len(store)} spilled blocks are in the host store (page them back "
              "in or mesh per region)")
    if args.mesh:
        with timer.span("mesh"):
            tris = extract_mesh_chunked(grid.volume,
                                        transfer="q16" if args.mesh_q16 else "f32")
            verts, faces = merge_vertices(tris)
        save_obj(args.mesh, verts, faces)
        result["mesh"] = {"vertices": len(verts), "faces": len(faces),
                          "ms": timer.mean_ms("mesh")}
        print(f"[offline] mesh: {len(verts)} verts, {len(faces)} faces -> {args.mesh} "
              f"({result['mesh']['ms']:.1f} ms)")
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


def _run_distributed(args, replay, intrinsics, cfg, voxel, trunc, max_depth, device) -> dict:
    """Replay through the block-ownership-sharded volume
    (parallel/sharding.py) and print the per-shard scaling table; returns
    the volume, frames, wall seconds, per-shard active blocks and, with
    --save / --save-dist, the records and blocks written."""
    if device.type == "cuda":
        avail = torch.cuda.device_count()
        if avail < args.devices:
            print(f"[offline] ERROR: {args.devices} devices requested, {avail} available "
                  "(--device cpu shards the volume over that many CPU shards)")
            sys.exit(2)
        mesh = make_mesh(args.devices)
    else:
        mesh = make_mesh(devices=[device] * args.devices)
    base = dataclasses.replace(cfg, voxel_size=voxel, truncation=trunc)
    dist = DistributedTSDF(base, mesh)
    print(f"[offline] distributed: {args.devices} shards, "
          f"{dist.sub_cfg.num_blocks} blocks/shard")

    n = 0
    t0 = time.perf_counter()
    for frame in replay:
        dist.integrate(FrameInput(rgb=frame.rgb, depth=frame.depth, ht=frame.ht,
                                  lt=frame.lt), intrinsics, frame.cam_T_world, max_depth)
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
    dist.block_until_ready()
    wall = time.perf_counter() - t0
    # per-shard scaling table: active blocks per shard (the arithmetic
    # behind a multi-device FPS projection)
    per_shard = np.asarray(dist.active_blocks_per_shard())
    print(f"[offline] distributed done: {n} frames in {wall:.1f} s "
          f"({n / wall:.1f} FPS), {int(per_shard.sum())} active blocks")
    print("[offline] shard | active blocks | share")
    for i, a in enumerate(per_shard):
        print(f"[offline]   {i:3d} | {int(a):13d} | {a / max(per_shard.sum(), 1):.3f}")

    result = {"dist": dist, "frames": n, "wall_s": wall, "per_shard": per_shard.tolist(),
              "records": None, "dist_blocks": None}
    if args.save:
        rec = dist.gather_all_tsdf()  # [N, 4] f32 records, all shards
        rec.astype("<f4").tofile(args.save)
        result["records"] = rec.shape[0]
        print(f"[offline] saved {rec.shape[0]} voxels to {args.save}")
    if args.save_dist:
        result["dist_blocks"] = save_distributed(args.save_dist, dist)
        print(f"[offline] elastic checkpoint: {result['dist_blocks']} blocks -> "
              f"{args.save_dist} (restorable onto any device count via "
              "parallel.sharding.load_distributed)")
    return result


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
