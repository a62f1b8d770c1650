#!/usr/bin/env python3
"""The parity raycaster's render, for the PyTorch port of any checkout:
two trees timed by one code on one card.

Fuses the 60 frames of the bench replay (datasets/orbit_vga at the bench
preset, as the offline app does) into a fresh volume, then, at the
frame-0 view (640x480) and the app's 640x360 view (the last pose): the
raycast kernel checked bit-equal to raycast_reference on the card, and
its device time (a trace, median of 10, chip_smoke.kernel_ms); at 640x480
a captured RaycastStep as TSDFGrid.ray_cast runs it: wall ms a render
over 20 replays with the pose staged (an SE3) and with a DevicePose, the
graph's device ms (CUDA events around a bare replay, median of 10), each
hand kernel's device ms within it and the kernels a replay holds (a
trace).  Where the tree has the superblock bits' layouts (raycast_kernel.
LAYOUTS), each layout's kernel time too, and the launch's shape
(registers, shared memory, resident CTAs).  It runs against the
disinfect_slam_tpu_torch package under --root (default: this checkout);
the dataset and the timing code are always this checkout's, and only
what every tree since the raycast kernel has is called.  Needs a CUDA
device; prints the result as one JSON line.

  python3 scripts/port_raycast_stage.py [--root DIR] [--out FILE.json]

To compare a commit with its parent, unpack the parent's package into a
git-ignored directory and run parent, change, change, parent on one card:

  mkdir -p .verify_tmp/parent
  git archive PARENT disinfect_slam_tpu_torch | tar -x -C .verify_tmp/parent
  python3 scripts/port_raycast_stage.py --root .verify_tmp/parent --out parent1.json
"""

import argparse
import collections
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPLAYS = 20  # captured renders timed on the host clock


def captured(chip_smoke, rk, vol, cam, pose) -> dict:
    """A captured RaycastStep at one view: wall ms a render (staged SE3 and
    DevicePose), the graph's device ms, each kernel's within it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from disinfect_slam_tpu_torch.core.geometry import DevicePose

    step = rk.RaycastStep(vol.device)
    wall = {}
    for name, p in (("staged", pose), ("device", DevicePose.from_se3(pose, vol.device))):
        for _ in range(3):
            step(vol, cam, p, chip_smoke.RENDER_MAX_DEPTH)  # the capture, then replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPLAYS):
            step(vol, cam, p, chip_smoke.RENDER_MAX_DEPTH)
        torch.cuda.synchronize()
        wall[name] = 1e3 * (time.perf_counter() - t0) / REPLAYS
    replay = next(iter(step.graphs._graphs.values()))[0]  # the staged pose's graph
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            replay()
        torch.cuda.synchronize()
    counts = collections.Counter(e.name for e in prof.events() if e.device_type.name == "CUDA")
    res = {"wall_ms_staged": wall["staged"], "wall_ms_device_pose": wall["device"],
           "graph_device_ms": chip_smoke.cuda_time_ms(replay),
           "kernels_per_replay": {k: max(1, round(v / 5)) for k, v in counts.items()}}
    for kernel in ("raycast_kernel", "superblock_bits_kernel"):
        if any(kernel in k for k in counts):
            res[f"{kernel}_ms"] = chip_smoke.kernel_ms(replay, kernel)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose disinfect_slam_tpu_torch is timed")
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, REPO]

    import torch

    if not torch.cuda.is_available():
        print("port_raycast_stage: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    import disinfect_slam_tpu_torch
    from disinfect_slam_tpu_torch.apps import offline
    from disinfect_slam_tpu_torch.core.geometry import (SE3, CameraIntrinsics, CameraParams,
                                                        DevicePose)
    from disinfect_slam_tpu_torch.ops.cuda import raycast_kernel as rk
    from disinfect_slam_tpu_torch.ops.raycast import raycast_reference
    from disinfect_slam_tpu_torch.utils.timing import card_name_and_power

    pkg = os.path.dirname(os.path.abspath(disinfect_slam_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"disinfect_slam_tpu_torch came from {pkg}, not from {root}")
    card = card_name_and_power()
    dev = torch.device("cuda", 0)
    grid, _, frames, intr, max_depth = chip_smoke.fresh_bench_grid(offline, dev, 60)
    for fr in frames:
        grid.integrate(fr.rgb, fr.depth, fr.ht, fr.lt, max_depth, intr, fr.cam_T_world)
    torch.cuda.synchronize()
    vol = grid.volume
    res = {"root": root, "card": card}
    for name, (i, hgt, wid) in {"frame0": (0, 480, 640), "app": (-1, 360, 640)}.items():
        cam = CameraParams.create(CameraIntrinsics.create(*intr), hgt, wid)
        se3 = SE3.from_matrix(frames[i].cam_T_world)
        pose = DevicePose.from_se3(se3, dev)
        want = raycast_reference(vol, cam, pose, chip_smoke.RENDER_MAX_DEPTH)
        layouts = getattr(rk, "LAYOUTS", None) if name == "frame0" else None
        for layout in (None, *(layouts or ())):
            kw = {} if layout is None else {"layout": layout}
            got = rk.raycast(vol, cam, pose, chip_smoke.RENDER_MAX_DEPTH, **kw)
            if not all(torch.equal(getattr(got, f), getattr(want, f))
                       for f in chip_smoke.RAY_FIELDS):
                raise SystemExit(f"the raycast kernel differs from its plain version at {name} "
                                 f"(layout {layout})")
            res[f"{name}_kernel_ms" + ("" if layout is None else f"_{layout}")] = (
                chip_smoke.kernel_ms(lambda c=cam, k=kw: rk.raycast(
                    vol, c, pose, chip_smoke.RENDER_MAX_DEPTH, **k), "raycast_kernel"))
        if name == "frame0":
            res["captured"] = captured(chip_smoke, rk, vol, cam, se3)
            if hasattr(rk, "launch_shape"):
                res["shape"] = rk.launch_shape(vol)
    chip_smoke.log(f"[port_raycast_stage] {res}")
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
