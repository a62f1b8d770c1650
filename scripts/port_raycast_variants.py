#!/usr/bin/env python3
"""The raycast kernel's launch shape, variant by variant, on one card.

Copies this checkout's disinfect_slam_tpu_torch into a git-ignored
directory once a variant, patches csrc/raycast.cu's constants there
(threads a CTA, the CTAs a thread's registers must leave room for, the
warp's tile, the region), and runs scripts/port_raycast_stage.py on each copy in
its own process: the kernel bit-equal to its plain version, its device
time at 640x480 (both bits layouts) and 640x360, a captured render's
times, and the SASS instructions of each kernel (cuobjdump). The unpatched
tree runs first and last; --parent DIR runs another tree's package too,
first and last; --file NAME=PATH times a whole other csrc/raycast.cu (a
variant that is more than a constant, such as another launch geometry).
Needs a CUDA device; prints one JSON line a run (also appended to
OUT/results.jsonl) and a summary.

  python3 scripts/port_raycast_variants.py [--only NAME ...] [--parent DIR]
      [--file NAME=PATH ...] [--out DIR]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(REPO, ".verify_tmp", "raycast_variants")
SOURCE = os.path.join("disinfect_slam_tpu_torch", "csrc", "raycast.cu")
LINES = {"threads": "constexpr int kThreads = 512;",
         "ctas": "constexpr int kMinCtas = 2;",
         "tile": "constexpr int kTileW = 8, kTileH = 4;",
         "region": "constexpr int kRegionW = 4, kRegionH = 4;"}
# name: {constant: its new line}
VARIANTS = {
    "base": {},
    "tile16x2": {"tile": "constexpr int kTileW = 16, kTileH = 2;"},
    "t512_c3": {"ctas": "constexpr int kMinCtas = 3;"},
    "t256_c5": {"threads": "constexpr int kThreads = 256;", "ctas": "constexpr int kMinCtas = 5;"},
    "t1024_c1": {"threads": "constexpr int kThreads = 1024;",
                 "ctas": "constexpr int kMinCtas = 1;"},
}
FILES = {}  # name: a whole csrc/raycast.cu to time (--file)


def sass_counts(root: str, out_path: str) -> dict:
    """The SASS instructions of each kernel in the tree's built raycast
    library (cuobjdump; the whole listing written to out_path)."""
    from glob import glob

    libs = glob(os.path.join(root, "disinfect_slam_tpu_torch", "_build", "libraycast_*.so"))
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not libs or not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", max(libs, key=os.path.getmtime)],
                          capture_output=True, text=True).stdout
    with open(out_path, "w") as f:
        f.write(text)
    counts, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and line.strip().startswith("/*") and "*/" in line[6:]:
            counts[name] += 1
    return counts


def make_tree(name: str) -> str:
    """The package copied under WORK/name with the variant's lines."""
    root = os.path.join(WORK, name)
    pkg = os.path.join(root, "disinfect_slam_tpu_torch")
    if os.path.exists(root):
        shutil.rmtree(root)
    shutil.copytree(os.path.join(REPO, "disinfect_slam_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, SOURCE)
    with open(path) as f:
        src = f.read()
    if name in FILES:
        with open(FILES[name]) as f:
            src = f.read()
    for key, line in VARIANTS.get(name, {}).items():
        if LINES[key] not in src:
            raise SystemExit(f"{SOURCE} has no line {LINES[key]!r}")
        src = src.replace(LINES[key], line)
    with open(path, "w") as f:
        f.write(src)
    return root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", help="variants to run besides base")
    ap.add_argument("--out", default=os.path.join(REPO, ".verify_tmp", "raycast_variants_out"))
    ap.add_argument("--parent", help="also run this tree's package (a git-ignored "
                    "directory holding disinfect_slam_tpu_torch), first and last")
    ap.add_argument("--file", nargs="*", default=[], metavar="NAME=PATH",
                    help="also time PATH as csrc/raycast.cu, under NAME")
    args = ap.parse_args(argv)
    FILES.update(f.split("=", 1) for f in args.file)
    names = [n for n in [*VARIANTS, *FILES] if n != "base" and (not args.only or n in args.only)]
    os.makedirs(args.out, exist_ok=True)
    results = []
    order = ["base", *names, "base"]
    if args.parent:
        order = ["parent", *order, "parent"]
    for name in order:
        root = os.path.abspath(args.parent) if name == "parent" else make_tree(name)
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", "port_raycast_stage.py"), "--root",
             root], capture_output=True, text=True, timeout=600)
        with open(os.path.join(args.out, f"{len(results)}_{name}.err"), "w") as f:
            f.write(proc.stderr)
        if proc.returncode != 0:
            print(f"{name}: exit {proc.returncode}\n{proc.stderr[-3000:]}", file=sys.stderr)
            results.append({"variant": name, "rc": proc.returncode})
            continue
        res = {"variant": name, **json.loads(proc.stdout.strip().splitlines()[-1]),
               "sass": sass_counts(root, os.path.join(args.out, f"{name}.sass"))}
        print(json.dumps(res), flush=True)
        with open(os.path.join(args.out, "results.jsonl"), "a") as f:
            f.write(json.dumps(res) + "\n")
        results.append(res)
    for r in results:
        if "frame0_kernel_ms" in r:
            c = r["captured"]
            sass = {k.split("raycast_kernel")[-1][:12]: v for k, v in r.get("sass", {}).items()
                    if "raycast_kernel" in k}
            print(f"{r['variant']:10s} 640x480 {r['frame0_kernel_ms']:.4f} ms (device-memory "
                  f"bits {r.get('frame0_kernel_ms_device', float('nan')):.4f}), 640x360 "
                  f"{r['app_kernel_ms']:.4f}; captured graph {c['graph_device_ms']:.4f}, wall "
                  f"{c['wall_ms_staged']:.4f} / {c['wall_ms_device_pose']:.4f}; SASS {sass} "
                  f"({r['card']})")
    return 0 if all("frame0_kernel_ms" in r for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
