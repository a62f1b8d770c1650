#!/usr/bin/env python3
"""The splat render's stages, for the PyTorch port of any checkout: two
trees timed by one code on one card.

Fuses the 60 frames of the bench replay (datasets/orbit_vga at the bench
preset, as the offline app does) into a fresh volume, then runs
chip_smoke.py's render_split on it: the frame-0 view at 640x480 split by
CUDA events into the surface set, the plain projection, the card path's
buffers (surface set, projection where the kernels read planes, the two
splat kernels), the image assembly and the whole render, the two kernels'
device times, and five renders (frames 0-4) under the profiler (wall and
device ms, kernels per render, idle share); then the two kernels' device
times on chip_smoke.py's synthetic block rows at 640x480 and 1080p, each
kernel first checked bit-equal to its plain version.  It runs against the
disinfect_slam_tpu_torch package under --root (default: this checkout);
the dataset and the timing code are always this checkout's, and
render_split uses only what every tree of the port has.  Needs a CUDA
device; prints the result as one JSON line.

  python3 scripts/port_render_stage.py [--root DIR] [--out FILE.json]

To compare a commit with its parent, unpack the parent's package into a
git-ignored directory and run parent, change, change, parent on one card:

  mkdir -p .verify_tmp/parent
  git archive PARENT disinfect_slam_tpu_torch | tar -x -C .verify_tmp/parent
  python3 scripts/port_render_stage.py --root .verify_tmp/parent --out parent1.json
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def block_row_times(chip_smoke, dev) -> dict:
    """splat_zbuf_blocks' and splat_payload_blocks' device ms (profiler,
    median of 10) on chip_smoke.make_splat_blocks' rows at 640x480 and
    1080p; raises unless both buffers equal their plain versions."""
    import torch

    from disinfect_slam_tpu_torch.ops.cuda import splat_kernel as sk

    out = {}
    for label, (seed, img_h, img_w) in {"640x480": (3, 480, 640),
                                        "1080p": (4, 1080, 1920)}.items():
        rows, pool, geometry = chip_smoke.make_splat_blocks(seed, img_h, img_w, dev)
        zbuf = sk.splat_zbuf_blocks(*rows, pool[0], **geometry)
        pbuf = sk.splat_payload_blocks(*rows, *pool, zbuf, **geometry)
        zref = sk.splat_zbuf_blocks_reference(*rows, pool[0], **geometry)
        pref = sk.splat_payload_blocks_reference(*rows, *pool, zref, **geometry)
        if not (torch.equal(zbuf, zref) and torch.equal(pbuf, pref)):
            raise SystemExit(f"the splat kernels differ from their plain versions at {label}")
        out[label] = {
            "splat_zbuf_blocks": chip_smoke.kernel_ms(
                lambda: sk.splat_zbuf_blocks(*rows, pool[0], **geometry), "splat_zbuf"),
            "splat_payload_blocks": chip_smoke.kernel_ms(
                lambda: sk.splat_payload_blocks(*rows, *pool, zbuf, **geometry),
                "splat_payload")}
        del rows, pool, zbuf, pbuf, zref, pref
        torch.cuda.empty_cache()
    chip_smoke.log(f"[port_render_stage] block rows, kernel device ms: {out}")
    return out


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
        print("port_render_stage: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from disinfect_slam_tpu_torch.utils.timing import card_name_and_power
    import disinfect_slam_tpu_torch
    from disinfect_slam_tpu_torch.apps import offline

    pkg = os.path.dirname(os.path.abspath(disinfect_slam_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"disinfect_slam_tpu_torch came from {pkg}, not from {root}")
    card = card_name_and_power()
    dev = torch.device("cuda", 0)
    grid, _, frames, intr, max_depth = chip_smoke.fresh_bench_grid(offline, dev, 60)
    for fr in frames:
        grid.integrate(fr.rgb, fr.depth, fr.ht, fr.lt, max_depth, intr, fr.cam_T_world)
    torch.cuda.synchronize()
    res = {"root": root, "card": card,
           "split": chip_smoke.render_split(grid, intr, [fr.cam_T_world for fr in frames])}
    del grid
    torch.cuda.empty_cache()
    res["block_rows"] = block_row_times(chip_smoke, dev)
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
