#!/usr/bin/env python3
"""ICP's kernel and the tracked frame around it, for the PyTorch port of
any checkout: two trees timed by one code on one card.

At each pyramid level that DenseSLAM tracks on orbit_vga (640x480,
320x240 and 160x120 at track_res_scale 1; 320x240, 160x120 and 80x60 at
2; chip_smoke.py's icp_inputs: frame 59 against frame 58), icp_step's
result is first checked bit-equal to its plain version on the card and
on the CPU, then its device time a call is read from a profiler trace
(chip_smoke.kernel_ms: every kernel a call launches, median of 10) beside
its byte bound and, where the tree has it (`icp_kernel.chain`), the
order floor: 29 register chains of N / 8 dependent float32 adds.  A
tracked frame's totals weight the levels by their iterations (4, 5, 10).
Then the captured DenseSLAM of chip_smoke.py phase 8 over the 60 frames
at each scale: ms/frame over frames 3-59 (CUDA events, `--slam-runs`
fresh runs) and frames 45-59 under the profiler (device ms, kernels and
idle share a frame).  It runs against the disinfect_slam_tpu_torch
package under --root (default: this checkout); the dataset and the
timing code are always this checkout's.  Needs a CUDA device; prints the
result as one JSON line.

  python3 scripts/port_icp_stage.py [--root DIR] [--out FILE.json] [--slam-runs N]

To compare a commit with its parent, unpack the parent's package into a
git-ignored directory and run parent, change, change, parent on one card:

  mkdir -p .verify_tmp/parent
  git archive PARENT disinfect_slam_tpu_torch | tar -x -C .verify_tmp/parent
  python3 scripts/port_icp_stage.py --root .verify_tmp/parent --out parent1.json
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def level_times(chip_smoke, dev) -> dict:
    """{scale: {"levels": [...], "per_frame": {...}}}: each level's
    device ms a call, bound and order floor; raises unless the kernel
    equals its plain version on the card and the CPU."""
    import numpy as np
    import torch

    from disinfect_slam_tpu_torch.ops.cuda import icp_kernel

    delta = torch.tensor(0.05)
    dist2 = float(np.float32(0.25 * 0.25))
    chain = getattr(icp_kernel, "chain", None)
    out = {}
    for scale in (1, 2):
        levels = []
        for (T0, src, pack, ref_pose, intr, w, h), iters in zip(
                chip_smoke.icp_inputs(dev, scale), chip_smoke.ICP_ITERS):
            args = [t.to(dev) for t in (T0, src, pack, ref_pose, delta)]
            got = icp_kernel.icp_step(*args, intr, w, h, dist2)
            host = icp_kernel.icp_step_reference(T0, src, pack, ref_pose, delta, intr, w, h,
                                                 dist2)
            if not all(torch.equal(a.cpu(), b) for a, b in zip(got, host)):
                raise SystemExit(f"icp_step at {w}x{h} differs from its plain version")
            n = w * h
            res = {"w": w, "h": h, "iters": iters,
                   "bound_ms": chip_smoke.bound(n * (12 + 32), 0)["bound_ms"],
                   "ms": chip_smoke.kernel_ms(
                       lambda a=args, i=intr, w=w, h=h: icp_kernel.icp_step(*a, i, w, h, dist2),
                       "icp_")}
            if chain is not None:
                seed = torch.full((32,), 1e-3, device=dev)
                sink = torch.empty(32, device=dev)
                rows = -(-n // icp_kernel.ACC)
                res["order_floor_ms"] = chip_smoke.kernel_ms(
                    lambda r=rows: chain(seed, r, sink), "icp_chain")
            levels.append(res)
        keys = [k for k in ("ms", "bound_ms", "order_floor_ms") if k in levels[0]]
        out[scale] = {"levels": levels,
                      "per_frame": {k: sum(lv["iters"] * lv[k] for lv in levels) for k in keys}}
        chip_smoke.log(f"[port_icp_stage] scale {scale}: {out[scale]}")
    return out


def slam_times(chip_smoke, dev, runs: int) -> dict:
    """Captured DenseSLAM at each scale: ms/frame of `runs` fresh runs and
    one profiled run's frames 45-59."""
    import torch

    frames = chip_smoke.slam_frames()
    out = {}
    for scale in (1, 2):
        ms = []
        for _ in range(runs):
            slam, _, m, counts = chip_smoke.timed_slam(dev, frames, scale, True)
            ms.append(m)
            del slam
            torch.cuda.empty_cache()
        slam = chip_smoke.new_slam(dev, scale)
        prof = chip_smoke.slam_frames_profile(slam, frames)
        del slam
        torch.cuda.empty_cache()
        out[scale] = {"ms_per_frame": ms, "icp_step_per_frame": counts[3] / len(frames),
                      "profile": prof}
        chip_smoke.log(f"[port_icp_stage] captured SLAM scale {scale}: {out[scale]}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose disinfect_slam_tpu_torch is timed")
    ap.add_argument("--out", help="also write the result to this JSON file")
    ap.add_argument("--slam-runs", type=int, default=2,
                    help="fresh captured SLAM runs timed at each scale")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, REPO]

    import torch

    if not torch.cuda.is_available():
        print("port_icp_stage: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    import disinfect_slam_tpu_torch
    from disinfect_slam_tpu_torch.ops.cuda import build
    from disinfect_slam_tpu_torch.utils.timing import card_name_and_power

    pkg = os.path.dirname(os.path.abspath(disinfect_slam_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"disinfect_slam_tpu_torch came from {pkg}, not from {root}")
    _, log, seconds = build.build(["icp_step"])
    chip_smoke.log(f"[port_icp_stage] icp_step built in {seconds:.1f} s; ptxas: "
                   + " | ".join(ln.strip() for ln in log.splitlines()
                                if "Used" in ln or "spill" in ln or "entry" in ln))
    build.build(["errors", "fuse_rows", "sample_rows", "splat_rows"])
    dev = torch.device("cuda", 0)
    res = {"root": root, "card": card_name_and_power(), "levels": level_times(chip_smoke, dev)}
    if args.slam_runs > 0:
        res["slam"] = slam_times(chip_smoke, dev, args.slam_runs)
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
