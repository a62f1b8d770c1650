#!/usr/bin/env python3
"""The probes P8/P9 (the splat z-buffer from given inputs) and P4/P5 (the
sampler's stripped modes) of the PyTorch port, on the scripts' own inputs
and sizes, on one card.

splat_probe.run_given and sample_probe.run_modes hold every function bit
for bit against its plain version on the card and time it by device
time from a trace (chip_smoke.probe_timer: kernel_ms, median of 10,
summed over the kernels a call launches, floored at the bound), beside
the plain version and the library call.  Then the z-buffer's merge is
A/B'd at P8's S = 12288 for run_v2i and run_v3: the shipped kernel
(footprints min-merged in a shared patch, one global atomicMin a patch
pixel) against the same source with the shared patch left out (one
global atomicMin a footprint pixel; ATOMIC, built beside the package's
library with its nvcc flags), each checked against the plain version
first, then timed in turns (shipped, atomic, atomic, shipped) over
--rounds rounds.  It runs against the disinfect_slam_tpu_torch package
under --root (default: this checkout); the timing code is always this
checkout's.  Needs a CUDA device; prints the result as one JSON line.

  python3 scripts/port_given_probes_stage.py [--root DIR] [--rounds N] [--out FILE.json]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the shipped merge's line and the line that sends every footprint pixel
# to the z-buffer instead (the shared patch then stays BIG and merges
# nothing)
ATOMIC = ("      if (c < kPatchW) {\n", "      if (false) {\n")


def atomic_entry(build):
    """dst_probe_splat_zbuf_given of csrc/splat_probe.cu with ATOMIC
    applied, compiled with the package's flags."""
    src = open(os.path.join(build.CSRC, "splat_probe.cu")).read()
    if src.count(ATOMIC[0]) != 1:
        raise SystemExit(f"splat_probe.cu: {ATOMIC[0]!r} found {src.count(ATOMIC[0])} times")
    out = build.BUILD_DIR / "given_stage"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / "splat_probe_atomic.cu", out / "libsplat_probe_atomic.so"
    cu.write_text(src.replace(*ATOMIC))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
                    str(cu)], check=True)
    fn = ctypes.CDLL(str(lib)).dst_probe_splat_zbuf_given
    p = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, p, p, p, p, p, p, ctypes.c_int, p, p]
    fn.restype = ctypes.c_int
    return fn


def zbuf_ab(zp, build, chip_smoke, dev, rounds: int) -> dict:
    """The shipped merge against ATOMIC's for run_v2i and run_v3 at P8's
    inputs, in turns, each checked against the plain version first."""
    import torch

    entry = atomic_entry(build)
    t = [torch.from_numpy(a).to(dev) for a in zp.pallas_inputs("P8")]

    def atomic(function):
        zbuf = torch.empty((zp.HPAD, zp.WPAD), dtype=torch.int32, device=dev)
        build.check(entry(zp.KERNEL_MODES[function], *(build.ptr(x) for x in t[:6]),
                          t[3].shape[0], build.ptr(zbuf), build.stream_of(zbuf)),
                    f"atomic {function}")
        return zbuf

    calls = {"shipped": lambda f: zp.splat_zbuf_given(*t, f), "atomic": atomic}
    yard = chip_smoke.bound(zp.given_bytes(t[3]), 0)
    out = {"bytes": yard["bytes"], "bound_ms": yard["bound_ms"]}
    for function in ("run_v2i", "run_v3"):
        plain = zp.splat_zbuf_given_reference(*t, function)
        for name, call in calls.items():
            if not torch.equal(call(function), plain):
                raise AssertionError(f"{function} {name}: differs from its plain version")
        ms = {name: [] for name in calls}
        for _ in range(rounds):
            for name in ("shipped", "atomic", "atomic", "shipped"):
                ms[name].append(chip_smoke.kernel_ms(
                    lambda c=calls[name]: c(function), "zbuf_given", floor_ms=yard["bound_ms"]))
        out[function] = ms
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose disinfect_slam_tpu_torch is timed")
    ap.add_argument("--rounds", type=int, default=2, help="A/B rounds of the z-buffer merges")
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, REPO]

    import torch

    if not torch.cuda.is_available():
        print("port_given_probes_stage: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    import disinfect_slam_tpu_torch
    from disinfect_slam_tpu_torch.ops.cuda import build
    from disinfect_slam_tpu_torch.ops.cuda import sample_probe as sp
    from disinfect_slam_tpu_torch.ops.cuda import splat_probe as zp
    from disinfect_slam_tpu_torch.utils.timing import card_name_and_power

    pkg = os.path.dirname(os.path.abspath(disinfect_slam_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"disinfect_slam_tpu_torch came from {pkg}, not from {root}")
    dev = torch.device("cuda", 0)
    res = {"root": root, "card": card_name_and_power(),
           "given": zp.run_given(dev, chip_smoke.probe_timer),
           "modes": sp.run_modes(dev, chip_smoke.probe_timer),
           "zbuf_ab": zbuf_ab(zp, build, chip_smoke, dev, args.rounds)}
    chip_smoke.log(f"[port_given_probes_stage] {res}")
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
