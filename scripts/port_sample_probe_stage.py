#!/usr/bin/env python3
"""The frame sampler's window probes (P1/P2/P3/P6), for the PyTorch port of
any checkout: two trees timed by one code on one card.

On chip_smoke.py's phase-7 rows (a random 640x480 8-channel frame, 32768
rows of 512 voxels, 32207 live, each row's pixels in a 14x14 footprint):
every window mode of ops/cuda/sample_probe.py (24x32 and 48x64 at 1, 4 and
16 rows a CTA, and P3's mode) checked bit-equal to patch_sample_reference
on the card (channels, valid, skipped), its device time (a trace, median
of 10, chip_smoke.kernel_ms) beside the byte bound chip_smoke phase 7
counts, K1's direct body (sample_direct full) on the same rows, and, where
the tree stages footprint boxes (sample_probe.staging_stats), what each
window shape stages and the 48x64 modes at other slot sizes (--slots).
It runs against the disinfect_slam_tpu_torch package under --root
(default: this checkout); the rows and the timing code are always this
checkout's.  Needs a CUDA device; prints the result as one JSON line.

  python3 scripts/port_sample_probe_stage.py [--root DIR] [--slots B ...] [--out FILE.json]

To compare a commit with its parent, unpack the parent's package into a
git-ignored directory and run parent, change, change, parent on one card:

  mkdir -p .verify_tmp/parent
  git archive PARENT disinfect_slam_tpu_torch | tar -x -C .verify_tmp/parent
  python3 scripts/port_sample_probe_stage.py --root .verify_tmp/parent --out parent1.json
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
    ap.add_argument("--slots", type=int, nargs="*", default=[],
                    help="other ring slot sizes (bytes) to time the 48x64 modes at")
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, REPO]

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_sample_probe_stage: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    import disinfect_slam_tpu_torch
    from disinfect_slam_tpu_torch.ops.cuda import sample_probe as sp
    from disinfect_slam_tpu_torch.utils.timing import card_name_and_power

    pkg = os.path.dirname(os.path.abspath(disinfect_slam_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"disinfect_slam_tpu_torch came from {pkg}, not from {root}")
    dev = torch.device("cuda", 0)
    img, u, v = chip_smoke.make_frame(np.random.default_rng(7), chip_smoke.H, chip_smoke.W, dev)
    count = torch.tensor(chip_smoke.COUNT, dtype=torch.int32, device=dev)
    n = chip_smoke.COUNT
    u0, v0 = sp.patch_origins(u, v, chip_smoke.H, chip_smoke.W)
    nbytes = 41 * 512 * n + 8 * n + img.numel() * 4  # as sample_probe.patch counts them
    floor = chip_smoke.bound(nbytes, 0)["bound_ms"]
    staged = hasattr(sp, "staging_stats")
    res = {"root": root, "card": card_name_and_power(), "bound_ms": floor, "modes": {}}

    def timed(label, fn, ref, kernel):
        got = fn()
        torch.cuda.synchronize()
        err = sp._check_patch(label, got, ref, n)  # raises unless bit-equal
        res["modes"][label] = {"ms": chip_smoke.kernel_ms(fn, kernel, floor_ms=floor), **err}

    for shape, (ph, pw) in enumerate(sp.PATCH_SHAPES):
        ref = sp.patch_sample_reference(img, u, v, count, u0, v0, ph, pw)
        if staged:
            res[f"staging_{ph}x{pw}"] = sp.staging_stats(img, u, v, count, u0, v0, ph, pw)
        for rpc in sp.ROWS_PER_CTA:
            timed(f"{ph}x{pw} {rpc}", lambda s=shape, r=rpc: sp.sample_patch(
                img, u, v, count, u0, v0, s, r), ref, "sample_patch_kernel")
            if staged and shape == 1:
                for slot in args.slots:
                    timed(f"{ph}x{pw} {rpc} slot {slot}", lambda r=rpc, b=slot: sp.sample_patch(
                        img, u, v, count, u0, v0, 1, r, slot_bytes=b), ref, "sample_patch_kernel")
        if shape == 0 and hasattr(sp, "sample_mma"):
            timed("P3 mma", lambda: sp.sample_mma(img, u, v, count, u0, v0), ref,
                  "sample_mma_kernel")
    res["k1_direct_ms"] = chip_smoke.kernel_ms(lambda: sp.sample_direct(img, u, v, count, 0),
                                               "sample_direct_kernel", floor_ms=floor)
    chip_smoke.log(f"[port_sample_probe_stage] {res}")
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
