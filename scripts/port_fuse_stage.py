#!/usr/bin/env python3
"""The offline fusion's stages, and its fuse stage alone, for the PyTorch
port of any checkout: two trees timed by one code on one card.

Runs chip_smoke.py's fusion_split (frames 45-59 of the bench replay split
into integrate's stages by CUDA events, after frames 0-44 on a fresh
volume) and then its fusion_profile (the same frames under the profiler,
then fuse_visible alone on frame 59's visible set, with the fuse_rows
kernel's share of it) against the disinfect_slam_tpu_torch package under
--root (default: this checkout).  The dataset and the timing code are
always this checkout's; both functions use only what every tree of the
port has.  Needs a CUDA device; prints the result as one JSON line.

  python3 scripts/port_fuse_stage.py [--root DIR] [--out FILE.json]

To compare a commit with its parent, unpack the parent's package into a
git-ignored directory and run parent, change, change, parent on one card:

  mkdir -p .verify_tmp/parent
  git archive PARENT disinfect_slam_tpu_torch | tar -x -C .verify_tmp/parent
  python3 scripts/port_fuse_stage.py --root .verify_tmp/parent --out parent1.json
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        print("port_fuse_stage: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from disinfect_slam_tpu_torch.utils.timing import card_name_and_power
    import disinfect_slam_tpu_torch
    from disinfect_slam_tpu_torch.apps import offline
    from disinfect_slam_tpu_torch.ops.cuda import fuse_kernel

    pkg = os.path.dirname(os.path.abspath(disinfect_slam_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"disinfect_slam_tpu_torch came from {pkg}, not from {root}")
    card = card_name_and_power()
    dev = torch.device("cuda", 0)
    res = {"root": root, "card": card,
           "split": chip_smoke.fusion_split(offline, fuse_kernel, dev)}
    # after the split: a profiler trace slows the rest of the process
    res["profile"] = chip_smoke.fusion_profile(offline, dev)
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
