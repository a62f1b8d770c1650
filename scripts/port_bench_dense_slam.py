#!/usr/bin/env python
"""DenseSLAM's steady-state frame time on the PyTorch port (counterpart
of scripts/bench_dense_slam.py, with its configuration and sizes): 40
frames of the synthetic 640x480 orbit at 1 cm voxels, three bootstrap
frames, then the rest timed with one synchronisation.  The headline is
the captured step (the tracked frame as one CUDA graph, the counterpart
of the jitted JAX step): it prints the ms a frame, the lost frames and
the final pose's error against the orbit's own pose; the same run with
the eager step (capture=False) follows on stderr.

    python scripts/port_bench_dense_slam.py [--track-scale 2] [--device cpu]

It runs on the card unless asked for the CPU; DSTPU_TRACK_SCALE sets the
default of --track-scale.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from disinfect_slam_tpu_torch.config import TSDFConfig  # noqa: E402
from disinfect_slam_tpu_torch.io.orbit_scene import make_orbit_frames  # noqa: E402
from disinfect_slam_tpu_torch.systems.dense_slam import DenseSLAM  # noqa: E402
from disinfect_slam_tpu_torch.utils.device import resolve_device  # noqa: E402
from disinfect_slam_tpu_torch.utils.timing import card_name_and_power  # noqa: E402

W, H = 640, 480
K = (525.1, 525.3, 319.6, 239.7)
FRAMES, WARM = 40, 3
CFG = TSDFConfig(
    voxel_size=0.01, truncation=0.06,
    num_blocks_log2=16, max_candidates=32768, max_visible=16384,
    max_new_per_round=8192, backend="dense", grid_log2=8,
    sampler_splits=2, alloc_stride=2,
)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(dev, frames, capture: bool, track_scale: int, w: int, h: int, K,
          cfg: TSDFConfig) -> dict:
    """One fresh DenseSLAM over the frames: the steady-state ms a frame
    over the frames after the WARM first, the lost count and the final
    pose's error in metres."""
    slam = DenseSLAM(K, h, w, voxel_size=cfg.voxel_size, truncation=cfg.truncation,
                     max_depth=4.0, cfg=cfg, track_res_scale=track_scale, device=dev,
                     capture=capture)
    for f in frames[:WARM]:  # bootstrap, and the first tracked frames (the captures)
        slam.process_frame(f[1], f[2])
    sync(dev)
    t0 = time.perf_counter()
    for f in frames[WARM:]:
        slam.process_frame(f[1], f[2])
    sync(dev)
    dt = time.perf_counter() - t0
    n = len(frames) - WARM
    # the final pose against the orbit's own
    gt = np.linalg.inv(frames[-1][0].astype(np.float64))
    est = slam.world_T_cam.astype(np.float64)
    return {"ms_per_frame": dt / n * 1e3, "lost": slam.lost_count, "frames": n,
            "final_pose_err_m": float(np.linalg.norm(gt[:3, 3] - est[:3, 3]))}


def run(device, track_scale: int = 1, n_frames: int = FRAMES, w: int = W, h: int = H,
        K=K, cfg: TSDFConfig = CFG) -> dict:
    """Track and fuse n_frames of the orbit at w x h, captured (printed)
    and then eager (on stderr); returns the captured run's numbers, with
    the eager run's ms a frame beside them."""
    dev = resolve_device(device)
    frames = make_orbit_frames(n_frames, w, h, K)
    card = card_name_and_power() if dev.type == "cuda" else "cpu"
    print(f"backend={dev.type} ({card}) track_scale={track_scale}", flush=True)
    res = timed(dev, frames, True, track_scale, w, h, K, cfg)
    eager = timed(dev, frames, False, track_scale, w, h, K, cfg)
    for label, r, out in (("", res, sys.stdout), (" (eager)", eager, sys.stderr)):
        print(f"dense_slam steady state{label}: {r['ms_per_frame']:.1f} ms/frame "
              f"({1e3 / r['ms_per_frame']:.2f} FPS), lost {r['lost']} of {r['frames']}, "
              f"final-pose err {r['final_pose_err_m'] * 100:.2f} cm", file=out, flush=True)
    return {**res, "eager_ms_per_frame": eager["ms_per_frame"], "eager_lost": eager["lost"],
            "card": card}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--track-scale", type=int,
                    default=int(os.environ.get("DSTPU_TRACK_SCALE", "1")))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.device, args.track_scale)


if __name__ == "__main__":
    main()
