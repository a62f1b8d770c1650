"""Online semantic reconstruction on the PyTorch port (counterpart of
apps/online.py; reference examples/tsdf/online.cc).

Two paths over a logged dataset (the layout apps/offline.py replays):

  --fused   a synchronous loop of FusedOnlineStep.step: each frame is one
            upload, the seg forward and fusion on the device (the honest
            online FPS); --render-dir renders the final view.
  default   the asynchronous stack, as the reference lays out its threads
            (online.cc:23-70): a pose thread registers the trajectory
            into DISINFSystem's pose manager, the main thread segments
            each frame (InferenceEngine, 640x360 maps resized to the frame
            by the same linear resize) and enqueues it at --fps, and the
            TSDF thread fuses.

Segmentation weights are the shipped npz checkpoints of the JAX package
(--seg-weights takes another file of that format, such as
apps.train_seg writes); --seg-ckpt takes a flax msgpack checkpoint, the
JAX app's format (models/train.py:save_checkpoint writes it too).

--stereo reads a logdir of rectified {id}_left.png / {id}_right.png pairs
(io/logger.StereoFrameLogger's layout) instead of RGB-D frames: depth
comes from block matching on the device (ops/stereo.py; --stereo-method
flat or pyramid, --max-disp, --baseline in metres, fx from --config),
rgb is the left view, and a frame without a trajectory row takes the
identity pose on the --fused path and no pose on the asynchronous one.
On the --fused path the depth stays on the device
(FusedOnlineStep.step_device); the asynchronous one takes host frames.

Usage:
  python -m disinfect_slam_tpu_torch.apps.online --logdir datasets/orbit_vga \
      --config datasets/orbit_vga/cam.yaml --segment --fused --render-dir out

It runs on the CUDA device unless asked for another (--device cpu).
"""

from __future__ import annotations

import argparse
import dataclasses
import threading
import time

import numpy as np
import torch

from ..config import TSDFConfig
from ..io.config_reader import get_depth_factor, get_intrinsics, load_yaml
from ..io.dataset import LoggedReplay, LoggedStereoReplay, ReplayFrame
from ..io.png_io import read_png
from ..models.segmentation import (
    InferenceEngine, default_weights_path, load_model, resize_linear,
)
from ..models.train import load_params
from ..ops.stereo import METHODS as STEREO_METHODS
from ..ops.stereo import StereoDepthEstimator
from ..systems.disinf_system import DISINFSystem
from ..systems.online_step import FusedOnlineStep
from ..systems.tsdf_grid import TSDFGrid
from ..utils.device import resolve_device
from ..viz.headless import render_to_png


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logdir", required=True)
    ap.add_argument("--config", help="camera YAML")
    ap.add_argument("--voxel", type=float, default=0.05)
    ap.add_argument("--trunc", type=float, default=0.2)
    ap.add_argument("--max-depth", type=float, default=4.0)
    ap.add_argument("--fps", type=float, default=30.0, help="playback rate")
    ap.add_argument("--segment", action="store_true", help="run ht/lt segmentation")
    ap.add_argument("--seg-weights",
                    help="segmentation checkpoint (npz of flat flax names, the "
                         "shipped format); default: the shipped weights")
    ap.add_argument("--seg-ckpt", help="segmentation checkpoint (flax msgpack, the "
                                       "JAX app's format); overrides --seg-weights")
    ap.add_argument("--seg-arch", default="unet", choices=["unet", "fast"],
                    help="segmentation model family: 'unet' (quality) or "
                         "'fast' (latency-first 2-resolution trunk)")
    ap.add_argument("--fused", action="store_true",
                    help="synchronous loop of seg + fusion per frame "
                         "(systems/online_step.py), no host round trip between them")
    ap.add_argument("--stereo", action="store_true",
                    help="logdir holds {id}_left/_right.png stereo pairs; depth is "
                         "computed by block matching instead of read from _depth.png")
    ap.add_argument("--baseline", type=float, default=0.12,
                    help="stereo baseline in metres (ZED: 0.12)")
    ap.add_argument("--stereo-method", choices=STEREO_METHODS, default="flat",
                    help="block matcher: the flat full cost volume or the "
                         "coarse-to-fine pyramid (less work)")
    ap.add_argument("--max-disp", type=int, default=64)
    ap.add_argument("--auto-recenter", action="store_true",
                    help="dense backend: move the coverage window after the camera "
                         "near its edge (TSDFGrid.maybe_recenter; the asynchronous "
                         "path)")
    ap.add_argument("--render-dir")
    ap.add_argument("--preset", choices=["full", "small"], default="full")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the volume, the net and the kernels; "
                         "without CUDA the run stops unless this is cpu")
    args = ap.parse_args(argv)
    if args.auto_recenter and args.fused:
        ap.error("--auto-recenter drives DISINFSystem, the path without --fused")
    return args


class StereoDepthReplay:
    """A stereo logdir replayed as RGB-D frames (the JAX app's
    _StereoAsRGBD): depth from the block matcher, rgb the left view
    (three channels), ht zeros and lt ones, the identity where the
    trajectory has no pose.  `entries` keep the logged poses (None where
    missing)."""

    def __init__(self, logdir: str, estimator: StereoDepthEstimator):
        self.stereo = LoggedStereoReplay(logdir)
        self.estimator = estimator
        self.entries = self.stereo.entries

    def __len__(self) -> int:
        return len(self.stereo)

    def frame_shape(self):
        fid = self.entries[0][0]
        return read_png(f"{self.stereo.logdir}/{fid}_left.png").shape[:2]

    def __iter__(self):
        for fr in self.stereo:
            depth = self.estimator(fr.left, fr.right)
            rgb = fr.left if fr.left.ndim == 3 else np.repeat(fr.left[..., None], 3, axis=-1)
            pose = np.eye(4, dtype=np.float32) if fr.cam_T_world is None else fr.cam_T_world
            yield ReplayFrame(fr.frame_id, pose, rgb, depth, np.zeros_like(depth),
                              np.ones_like(depth))

    def device_frames(self):
        """(rgb [H, W, 3], depth f32 [H, W], cam_T_world) a frame, the
        images on the estimator's device (FusedOnlineStep.step_device):
        the host pair goes to the captured estimator, which uploads it once
        through its pinned staging, and the depth never leaves the device
        (an eager estimator takes the pair uploaded here)."""
        device = self.estimator.device
        for fr in self.stereo:
            if self.estimator.capture:
                depth = self.estimator.depth_device(fr.left, fr.right)
                left = self.estimator.left_device()
            else:
                left = torch.from_numpy(np.ascontiguousarray(fr.left)).to(device)
                right = torch.from_numpy(np.ascontiguousarray(fr.right)).to(device)
                depth = self.estimator.depth_device(left, right)
            rgb = left if left.ndim == 3 else left[..., None].expand(*left.shape, 3)
            pose = np.eye(4, dtype=np.float32) if fr.cam_T_world is None else fr.cam_T_world
            yield rgb, depth, pose


def _render(grid, args, intrinsics, last_pose):
    paths = render_to_png(grid, args.render_dir, last_pose, (intrinsics, 360, 640),
                          max_depth=args.max_depth, renderer="auto")
    print(f"[online] rendered final view to {args.render_dir}")
    return list(paths)


def run(args) -> dict:
    """Replay the dataset through the chosen path.  Returns frames, wall
    seconds, FPS, active blocks, the volume's owner (`step` or `system`)
    and the rendered PNG paths."""
    device = resolve_device(args.device)
    cfg = None
    if args.preset == "small":
        cfg = TSDFConfig(num_blocks_log2=12, max_candidates=8192, max_visible=4096,
                         max_new_per_round=2048, grid_log2=7)
    if args.config:
        cam_yaml = load_yaml(args.config)
        intrinsics = get_intrinsics(cam_yaml)
        depth_factor = get_depth_factor(cam_yaml)
    else:
        intrinsics = (517.3, 516.5, 318.6, 255.3)
        depth_factor = 5000.0
    model = None
    if args.segment and args.seg_ckpt:
        print(f"[online] seg checkpoint {args.seg_ckpt}")
        model = load_model(args.seg_arch, params=load_params(args.seg_ckpt), device=device)
    elif args.segment:
        path = args.seg_weights or default_weights_path(args.seg_arch)
        print(f"[online] seg weights {path}")
        model = load_model(args.seg_arch, path, device=device)
    if args.stereo:
        # a stereo-only sensor: no RGB-D camera needed (the reference
        # requires an L515 here, online.cc:23-70)
        est = StereoDepthEstimator(fx=intrinsics[0], baseline_m=args.baseline,
                                   max_disp=args.max_disp, max_depth=args.max_depth,
                                   method=args.stereo_method, device=device)
        replay = StereoDepthReplay(args.logdir, est)
        print(f"[online] stereo replay: depth by {args.stereo_method} block matching "
              f"(baseline {args.baseline} m, max_disp {args.max_disp})")
    else:
        replay = LoggedReplay(args.logdir, depth_factor)
    print(f"[online] {len(replay)} frames @ {args.fps} fps playback on {device}")
    last_pose = replay.entries[-1][1]
    if last_pose is None:  # a stereo capture without trajectory rows
        last_pose = np.eye(4, dtype=np.float32)
    out = {"render_paths": None}

    if args.fused:
        if args.stereo:
            fh, fw = replay.frame_shape()
        else:
            fh, fw = replay.load_frame(*replay.entries[0]).depth.shape
        ocfg = dataclasses.replace(cfg or TSDFConfig(), voxel_size=args.voxel,
                                   truncation=args.trunc)
        step = FusedOnlineStep(ocfg, intrinsics, fh, fw, args.max_depth,
                               seg_model=model, device=device)
        t0 = time.perf_counter()
        n = 0
        if args.stereo:
            for rgb, depth, pose in replay.device_frames():
                step.step_device(rgb, depth, pose)
                n += 1
        else:
            for frame in replay:
                step.step(frame.rgb, frame.depth, frame.cam_T_world)
                n += 1
        step.block_until_ready()
        wall = time.perf_counter() - t0
        blocks = step.num_active_blocks()
        print(f"[online] fused: {n} frames in {wall:.1f} s ({n / wall:.1f} FPS incl "
              f"upload+seg), {blocks} active blocks")
        out.update(step=step)
        if args.render_dir:
            grid = TSDFGrid(args.voxel, args.trunc, cfg=ocfg, device=device)
            grid.volume = step.volume
            out["render_paths"] = _render(grid, args, intrinsics, last_pose)
        return {**out, "frames": n, "wall_s": wall, "fps": n / wall,
                "active_blocks": blocks}

    segmenter = None
    if model is not None:
        engine = InferenceEngine(model)

        def segmenter(rgb):
            # the 640x360 maps resized to the frame on the host, as the
            # JAX app does with cv2.resize
            ht, lt = engine.infer_one(rgb)
            maps = torch.from_numpy(np.stack([ht, lt], -1))
            maps = resize_linear(maps, *rgb.shape[:2]).numpy()
            return maps[..., 0], maps[..., 1]

    with DISINFSystem(intrinsics, depth_factor=1.0,  # the replay scales depth
                      voxel_size=args.voxel, truncation=args.trunc,
                      max_depth=args.max_depth, segmenter=segmenter,
                      half_scale=False, cfg=cfg, auto_recenter=args.auto_recenter,
                      device=device) as system:
        period = 1.0 / args.fps
        t_start = time.perf_counter()

        def pose_thread():
            # plays the trajectory as the "SLAM" stream, slightly ahead
            for i, (_, pose) in enumerate(replay.entries):
                if pose is None:  # a stereo capture without trajectory rows
                    continue
                system.feed_pose(int(i * 1000 * period), pose)
                time.sleep(period * 0.5)

        tp = threading.Thread(target=pose_thread, daemon=True)
        tp.start()
        n = 0
        for i, frame in enumerate(replay):
            system.feed_rgbd_frame(frame.rgb, frame.depth, int(i * 1000 * period))
            n += 1
            if n % 30 == 0:
                print(f"[online] {n} frames, queue depth {system.tsdf.queue_depth()}, "
                      f"{system.tsdf.tsdf.num_active_blocks()} blocks")
            dt = t_start + (i + 1) * period - time.perf_counter()  # pace playback
            if dt > 0:
                time.sleep(dt)
        tp.join(timeout=60.0)
        system.tsdf.flush()
        wall = time.perf_counter() - t_start
        if system.tsdf.dropped_frames:
            raise RuntimeError(f"{system.tsdf.dropped_frames} of {n} frames failed "
                               "to integrate (see the log)")
        blocks = system.tsdf.tsdf.num_active_blocks()
        print(f"[online] done: {n} frames in {wall:.1f} s ({n / wall:.1f} FPS "
              f"sustained), {blocks} active blocks")
        out.update(system=system)
        if args.render_dir:
            out["render_paths"] = _render(system.tsdf.tsdf, args, intrinsics, last_pose)
    return {**out, "frames": n, "wall_s": wall, "fps": n / wall, "active_blocks": blocks}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
